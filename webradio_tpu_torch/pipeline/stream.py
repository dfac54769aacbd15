"""Offline capture runners and the serving catch-up (port of
``webradio_tpu.pipeline.stream``, both engines).

The JAX package scans a recorded capture with ``lax.scan`` over the same
step the live server uses; here each runner is a loop over the port's step
(``frontend_step`` / ``channelized_step``), so offline and live paths run
the same kernels in the same order. Every block's audio and latest
spectrum row is copied into one output made before the loop, on the
device: the loop never waits for the device (no CUDA graph yet).
"""

from __future__ import annotations

import torch

from ..ops.spectrum import spectrum_db
from .channelized import (
    ChannelizedConfig,
    channelized_step,
    init_channelized_state,
)
from .frontend import frontend_step
from .state import ChainConfig, FrontEndParams, FrontEndState, init_state


def _run(step, cfg, params, state, iq: torch.Tensor):
    """``iq [2, total_frames]`` through ``step`` block by block:
    ``(final_state, audio [C, total_audio], latest [n_blocks, 2,
    fft_size])``; the capture is truncated to whole blocks."""
    bf = cfg.block_frames
    n_blocks = iq.shape[-1] // bf
    if n_blocks == 0:
        raise ValueError("capture shorter than one block")
    af = cfg.audio_frames
    audio = torch.empty((cfg.num_channels, n_blocks * af),
                        dtype=torch.float32, device=iq.device)
    latest = torch.empty((n_blocks, 2, cfg.fft_size), dtype=torch.float32,
                         device=iq.device)
    for b in range(n_blocks):
        state, a, spectra = step(cfg, params, state,
                                 iq[:, b * bf:(b + 1) * bf])
        audio[:, b * af:(b + 1) * af] = a
        latest[b] = spectra[:, -1, :]
    return state, audio, latest


def run_capture(
    cfg: ChainConfig,
    params: FrontEndParams,
    iq: torch.Tensor,
    state: FrontEndState | None = None,
):
    """Demodulate a whole recorded capture on the direct engine.

    Args:
      iq: ``[2, total_frames]`` float32 IQ planes on the parameters'
        device; truncated to a whole number of blocks of
        ``cfg.block_frames`` (ValueError on less than one block).
      state: the carried state to start from; None starts from the init
        state.

    Returns:
      ``(final_state, audio, latest_spectra)`` — audio ``[C, total_audio]``
      float32 (blocks concatenated in time), and per-block latest spectrum
      rows ``[num_blocks, 2, fft_size]`` raw DFT planes.
    """
    if state is None:
        state = init_state(cfg, iq.device)
    return _run(frontend_step, cfg, params, state, iq)


def run_capture_channelized(cfg: ChannelizedConfig, params, iq: torch.Tensor,
                            state=None):
    """Channelized-engine counterpart of :func:`run_capture` (same
    contract; ``cfg`` is a ChannelizedConfig). Where the step takes a
    fused tail kernel (every slot sharing one FIR kernel, C >= 512 under
    "auto"), it is launched once a block."""
    if state is None:
        state = init_channelized_state(cfg, iq.device)
    return _run(channelized_step, cfg, params, state, iq)


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
