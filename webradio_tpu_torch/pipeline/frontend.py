"""Front-end helpers shared by the engines (subset of
``webradio_tpu.pipeline.frontend``): the squelch and gain scale."""

from __future__ import annotations

import torch


def squelch_scale(power: torch.Tensor, af_gain: torch.Tensor,
                  squelch_db: torch.Tensor) -> torch.Tensor:
    """Linear audio scale ``[C]`` from AF gain and the power-squelch gate.

    ``squelch_db`` is the per-channel gate threshold in dB relative to
    full-scale mean IQ power; NaN disables the gate. Any finite value gates
    for real, unlike the reference, which surfaces the field but never
    applies it (receiverhandler.cxx:118-119).
    """
    power_db = 10.0 * torch.log10(torch.clamp(power, min=1e-30))
    gate = torch.isnan(squelch_db) | (power_db >= squelch_db)
    return af_gain * gate.to(torch.float32)
