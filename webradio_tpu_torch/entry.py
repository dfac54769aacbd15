"""The flagship single-card step as ``(fn, example_args)``: the port's twin
of ``__graft_entry__.entry``.

The flagship model is the direct front-end block program at the
reference's stock rates (2.4 Msps -> 240 k -> 48 k, block = 102,400 IQ
frames, src/main.cxx:74-75) with a 16-receiver channel batch: IFs
``(i - 8) * 100 kHz``, 80 / 8 kHz bandwidths, laws FM, AM, USB, LSB four
times over. The multi-device dry run (``dryrun_multichip``) waits for the
port's multi-device layer (ROADMAP.md).
"""

from __future__ import annotations

import torch

from .pipeline.frontend import frontend_step
from .pipeline.state import ChainConfig, init_state, make_receiver_params

#: the flagship configuration: stock rates, 16 receivers
CONFIG = ChainConfig(num_channels=16)


def entry(device: torch.device | str | None = None):
    """Return ``(fn, (params, state, iq))`` on ``device`` (None: the CUDA
    device, and an error where there is none).

    ``fn(params, state, iq)`` runs one block ``iq [2, 102400]`` (float32
    real planes, re and im) through the step and returns ``(audio [16,
    2048], latest spectrum planes [2, 512])``: the raw DFT planes of the
    block's last spectrum row. The example ``iq`` is zeros, as in the JAX
    package's entry.
    """
    cfg = CONFIG
    params = make_receiver_params(
        cfg,
        if_hz=[(i - 8) * 100_000 for i in range(16)],
        if_bandwidth_hz=80_000,
        af_bandwidth_hz=8_000,
        mode=["FM", "AM", "USB", "LSB"] * 4,
        device=device,
    )
    state = init_state(cfg, params.rx.phase_step.device)
    iq = torch.zeros((2, cfg.block_frames), dtype=torch.float32,
                     device=state.rx.chan_hist.device)

    def fn(params, state, iq):
        _, audio, spectra = frontend_step(cfg, params, state, iq)
        return audio, spectra[:, spectra.shape[1] - 1, :]

    return fn, (params, state, iq)
