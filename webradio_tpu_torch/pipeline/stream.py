"""Offline capture runners and the serving catch-up (port of
``webradio_tpu.pipeline.stream``, both engines).

The JAX package scans a recorded capture with ``lax.scan`` over the same
step the live server uses, one dispatch for the whole scan. Here each
runner drives a pipeline of the engine (``ChannelizedPipeline`` /
``FrontEndPipeline``) block by block through ``step_device``, so offline
and live paths run the same step, kernels and graphs in the same order: on
the card each block is a copy into the pipeline's graph input and one
graph replay (``pipeline.graph.ServingGraphs``, captured once per call
after one eager block), then a copy of its outputs into the result made
before the loop; on the CPU (or with ``graph=False``) the eager in-place
step runs block by block.
"""

from __future__ import annotations

import torch

from .channelized import ChannelizedConfig, ChannelizedPipeline
from .frontend import FrontEndPipeline
from .state import ChainConfig, FrontEndParams, FrontEndState


def _pipeline(cfg, params, state, graph: bool):
    """A pipeline of ``cfg``'s engine starting from a copy of ``state``
    (None: the init state)."""
    pipe = (ChannelizedPipeline if isinstance(cfg, ChannelizedConfig)
            else FrontEndPipeline)(cfg, params, graph)
    if state is not None:
        pipe.load_state(state)
    return pipe


def _run(cfg, params, state, iq: torch.Tensor, graph: bool):
    """``iq [2, total_frames]`` through the engine block by block:
    ``(final_state, audio [C, total_audio], latest [n_blocks, 2,
    fft_size])``; the capture is truncated to whole blocks."""
    bf = cfg.block_frames
    n_blocks = iq.shape[-1] // bf
    if n_blocks == 0:
        raise ValueError("capture shorter than one block")
    pipe = _pipeline(cfg, params, state, graph)
    af = cfg.audio_frames
    audio = torch.empty((cfg.num_channels, n_blocks * af),
                        dtype=torch.float32, device=iq.device)
    latest = torch.empty((n_blocks, 2, cfg.fft_size), dtype=torch.float32,
                         device=iq.device)
    for b in range(n_blocks):
        a, raw, _ = pipe.step_device(iq[:, b * bf:(b + 1) * bf])
        audio[:, b * af:(b + 1) * af].copy_(
            a.T if pipe.audio_time_major else a)
        latest[b].copy_(raw)
    return pipe.state, audio, latest


def run_capture(
    cfg: ChainConfig,
    params: FrontEndParams,
    iq: torch.Tensor,
    state: FrontEndState | None = None,
    graph: bool = True,
):
    """Demodulate a whole recorded capture on the direct engine.

    Args:
      iq: ``[2, total_frames]`` float32 IQ planes on the parameters'
        device; truncated to a whole number of blocks of
        ``cfg.block_frames`` (ValueError on less than one block).
      state: the carried state to start from (not written); None starts
        from the init state.
      graph: False runs the plain loop on the card too.

    Returns:
      ``(final_state, audio, latest_spectra)`` — audio ``[C, total_audio]``
      float32 (blocks concatenated in time), and per-block latest spectrum
      rows ``[num_blocks, 2, fft_size]`` raw DFT planes.
    """
    return _run(cfg, params, state, iq, graph)


def run_capture_channelized(cfg: ChannelizedConfig, params, iq: torch.Tensor,
                            state=None, graph: bool = True):
    """Channelized-engine counterpart of :func:`run_capture` (same
    contract; ``cfg`` is a ChannelizedConfig). Where the step takes a
    fused tail kernel (every slot sharing one FIR kernel, C >= 512 under
    "auto"), it is launched once a block."""
    return _run(cfg, params, state, iq, graph)


def scan_serving(cfg, params, state, blocks: torch.Tensor, mode_set=None,
                 graph: bool = True):
    """Run ``blocks [k, 2, block_frames]`` through the step in order.

    The catch-up of a backlog that reached the device as one copy, on a
    pipeline that starts from a copy of ``state``: on the card ``k``
    replays of its graphs, on the CPU (or with ``graph=False``) the eager
    step block by block. ``cfg`` is a ``ChannelizedConfig`` (the
    channelized engine) or a ``ChainConfig`` (the direct engine). Returns
    ``(state, audio [k, C, audio_frames], latest_db)`` where ``latest_db``
    is the LAST block's dB spectrum row (earlier rows would be overwritten
    before any reader saw them). ``mode_set`` is accepted for signature
    parity.
    """
    pipe = _pipeline(cfg, params, state, graph)
    audio, latest_db = pipe.step_blocks(blocks)
    return pipe.state, audio, latest_db
