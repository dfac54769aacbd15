"""Serving catch-up over a backlog of blocks (port of
``webradio_tpu.pipeline.stream.scan_serving``, both engines; the offline
capture runners come with the offline paths).
"""

from __future__ import annotations

import torch

from ..ops.spectrum import spectrum_db
from .channelized import ChannelizedConfig, channelized_step
from .frontend import frontend_step


def scan_serving(cfg, params, state, blocks: torch.Tensor, mode_set=None):
    """Run ``blocks [k, 2, block_frames]`` through the step in order.

    Used by the live pump when the ring backs up: the backlog reaches the
    device as one copy and the steps are enqueued back to back (a plain
    loop; no CUDA graph yet). ``cfg`` is a ``ChannelizedConfig`` (the
    channelized engine) or a ``ChainConfig`` (the direct engine). Returns
    ``(state, audio [k, C, audio_frames], latest_db)`` where ``latest_db``
    is the LAST block's dB spectrum row (earlier rows would be overwritten
    before any reader saw them). ``mode_set`` is accepted for signature
    parity.
    """
    step = (channelized_step if isinstance(cfg, ChannelizedConfig)
            else frontend_step)
    audio = []
    spectra = None
    for iq in blocks:
        state, a, spectra = step(cfg, params, state, iq)
        audio.append(a)
    return state, torch.stack(audio), spectrum_db(spectra[:, -1, :])
