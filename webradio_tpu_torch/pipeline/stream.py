"""Serving catch-up over a backlog of blocks (port of
``webradio_tpu.pipeline.stream.scan_serving`` for the channelized engine;
the offline capture runners come with the offline paths).
"""

from __future__ import annotations

import torch

from ..ops.spectrum import spectrum_db
from .channelized import ChannelizedConfig, channelized_step


def scan_serving(cfg, params, state, blocks: torch.Tensor, mode_set=None):
    """Run ``blocks [k, 2, block_frames]`` through the step in order.

    Used by the live pump when the ring backs up: the backlog reaches the
    device as one copy and the steps are enqueued back to back (a plain
    loop; no CUDA graph yet). Returns ``(state, audio [k, C,
    audio_frames], latest_db)`` where ``latest_db`` is the LAST block's dB
    spectrum row (earlier rows would be overwritten before any reader saw
    them). ``mode_set`` is accepted for signature parity.
    """
    if not isinstance(cfg, ChannelizedConfig):
        raise NotImplementedError(
            "scan_serving is ported for the channelized engine only "
            "(ROADMAP.md: the direct engine)")
    audio = []
    spectra = None
    for iq in blocks:
        state, a, spectra = channelized_step(cfg, params, state, iq)
        audio.append(a)
    return state, torch.stack(audio), spectrum_db(spectra[:, -1, :])
