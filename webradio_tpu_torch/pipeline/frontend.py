"""The direct front-end step: spectrum + every receiver channel mixed,
filtered and demodulated from the wideband block (port of
``webradio_tpu.pipeline.frontend``), and the double-buffered host interface
both engines share, which on the card runs each block as one CUDA graph
replay with the state updated in place (``.graph``; the JAX package jits
the step and donates the state).

Signal representation: IQ as float32 real planes ``[2, ..., N]``. The
direct engine runs no hand-written kernel (the JAX step reaches no Pallas
call either): a per-channel NCO mix of the whole block, the decimating
channel FIR, the demodulator and the decimating audio FIR, each a plain
torch function of ``ops``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.demod import demodulate
from ..ops.fir import fir_dispatch, overlap_save_decimate
from ..ops.nco import nco_advance, nco_mix
from ..ops.spectrum import spectrum_accumulate, spectrum_db
from .graph import CudaStepGraph, ServingGraphs, carry, layout, same_shapes
from .state import (
    ChainConfig,
    FrontEndParams,
    FrontEndState,
    ReceiverState,
    init_state,
)


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


def frontend_step(
    cfg: ChainConfig,
    params: FrontEndParams,
    state: FrontEndState,
    iq: torch.Tensor,
) -> tuple[FrontEndState, torch.Tensor, torch.Tensor]:
    """One block ``iq [2, block_frames]`` through spectrum + every receiver:
    ``(state, audio [C, audio_frames], spectra [2, blocks, fft_size])``
    (spectra row -1 is the reference's latest frame,
    spectrumsink.cxx:107-117)."""
    rxp, rxs = params.rx, state.rx
    spectra = spectrum_accumulate(iq, cfg.fft_size)
    mixed = nco_mix(iq[:, None, :], rxs.nco_phase, rxp.phase_step)
    nco_phase = nco_advance(rxs.nco_phase, rxp.phase_step, cfg.block_frames)

    def fir(x, coeff, toep, decim, hist):
        if cfg.use_overlap_save:
            return overlap_save_decimate(x, coeff, decim, hist)
        return fir_dispatch(x, coeff, toep, decim, hist)

    chan, chan_hist = fir(mixed, rxp.chan_coeff, rxp.chan_toep,
                          cfg.chan_decim, rxs.chan_hist)
    audio_if, demod_prev = demodulate(chan, rxp.mode, rxs.demod_prev)
    audio, audio_hist = fir(audio_if, rxp.audio_coeff, rxp.audio_toep,
                            cfg.audio_decim, rxs.audio_hist)
    # AF gain and the power squelch over the channel's mean post-filter
    # IQ power for the block
    power = (chan[0] ** 2 + chan[1] ** 2).mean(dim=-1)  # [C]
    audio = audio * squelch_scale(power, rxp.af_gain, rxp.squelch)[:, None]
    return FrontEndState(rx=ReceiverState(
        nco_phase=nco_phase,
        chan_hist=chan_hist,
        demod_prev=demod_prev,
        audio_hist=audio_hist,
    )), audio, spectra


def frontend_step_serving(
    cfg: ChainConfig,
    params: FrontEndParams,
    state: FrontEndState,
    iq: torch.Tensor,
) -> tuple[FrontEndState, torch.Tensor, torch.Tensor]:
    """Serving variant: ``(state, audio [C, audio_frames], latest spectrum
    row in dB [fft_size])`` (spectrumsink.cxx:125-142)."""
    new_state, audio, spectra = frontend_step(cfg, params, state, iq)
    return new_state, audio, spectrum_db(spectra[:, -1, :])


class HostPipeline:
    """The double-buffered host interface of both engines' pipelines.

    :meth:`process_host` copies a ``[2, N]`` float32 numpy block through a
    pinned staging buffer to the device without blocking, runs the serving
    step on the current CUDA stream and returns the PREVIOUS call's
    ``(audio, latest_db [fft_size])`` as device tensors (None on the first
    call); :meth:`flush` returns the last one. :meth:`process_host_many`
    does the same for a backlog ``[k, 2, N]`` (audio ``[k, C,
    audio_frames]``). Two staging buffers alternate, and a buffer is
    refilled only after the copy that last read it has finished. Not
    thread-safe: one thread drives it.

    The state is carried in persistent buffers that every step writes in
    place (:meth:`_step_in_place`; the JAX package donates the state to its
    jitted step instead). On a CUDA device each block is a replay of a
    captured CUDA graph (:class:`.graph.ServingGraphs`, the counterpart of
    the JAX package's ``jax.jit``): the in-place step on the slot's device
    input and a copy of its outputs into the slot's output set, one graph
    for each of the two slots. The tensors handed back for a block are
    that slot's outputs, rewritten by its replay two calls later: a caller
    that keeps them longer copies them. :meth:`step_device` feeds the same
    graphs from the device (the offline runners and the catch-up). The
    graphs are captured again where :meth:`graph_key` changes (the
    configuration, or the address of a parameter or state tensor: a
    bandwidth that leaves the shared FIR kernels, growth); the in-place
    slot scatter and :meth:`load_state` keep the addresses. On the CPU, or
    with ``graph=False``, every block runs the eager in-place step.
    ``graph_captures`` (graph sets captured), ``graph_replays``,
    ``graph_warms`` (eager blocks before a capture) and ``graph_kernels``
    (the kernel nodes of every replayed graph, summed: what a profiler
    trace of those replays must hold) count what the graphs did.

    PyTorch compiles nothing, so there is no warm-up of parameter variants
    or demod-law sets: any parameter change takes effect at the next block.
    """

    #: per-block process_host audio orientation: ``[audio_frames, C]``
    #: when True, else ``[C, audio_frames]``
    audio_time_major = False
    #: what a graph is made with (a test may put a stand-in here)
    graph_class = CudaStepGraph

    def __init__(self, cfg, params, device: torch.device, graph: bool = True):
        self.cfg = cfg
        self.params = params
        self.device = device
        #: False runs every block eagerly (for an A/B against the graphs)
        self.use_graph = graph
        self.state = self._init_state()
        self._pending = None
        #: per input shape: [two pinned buffers, their last copies' events,
        #: the slot to fill next]
        self._staging: dict[tuple, list] = {}
        self._graphs: ServingGraphs | None = None
        self.graph_captures = 0
        self.graph_replays = 0
        self.graph_warms = 0
        self.graph_kernels = 0

    def _init_state(self):
        raise NotImplementedError

    def _block(self, iq: torch.Tensor):
        """``(new state, audio in the serving layout, spectra [2, blocks,
        fft_size])`` of one block on the device."""
        raise NotImplementedError

    def graph_stats(self) -> dict:
        return {"captures": self.graph_captures,
                "replays": self.graph_replays,
                "warms": self.graph_warms,
                "kernels": self.graph_kernels}

    def update_params(self, params) -> None:
        """Take a whole new parameter set at the next block. Where it has
        the current set's layout (a law change or a retune on the
        per-channel fallback, a full rebuild that changed no structure)
        its values are copied into the current tensors, so the graphs go
        on serving; otherwise (a bandwidth that leaves or rejoins the
        shared FIR kernels) it takes their place, and the next block
        captures anew."""
        if same_shapes(self.params, params):
            carry(self.params, params)
        else:
            self.params = params

    def graphed(self) -> bool:
        """Whether blocks run as graph replays."""
        return self.use_graph and (self.device.type == "cuda"
                                   or self.graph_class is not CudaStepGraph)

    def graph_key(self) -> tuple:
        """What a captured step has fixed: the configuration (the path,
        the tier, C) and the address, shape and type of every parameter and
        state tensor."""
        return (self.cfg, layout(self.params), layout(self.state))

    def graph_kernels_per_block(self) -> int:
        """The kernel nodes of one served block's graph (0 before the
        first capture, or without graphs)."""
        graphs = self._graphs.graphs if self._graphs is not None else None
        return max(g.kernel_nodes for g in graphs) if graphs else 0

    def load_state(self, state) -> None:
        """Carry ``state`` in: copied into the persistent buffers where it
        has their shapes (the graphs keep reading them), else taking their
        place."""
        if same_shapes(self.state, state):
            carry(self.state, state)
        else:
            self.state = state

    def _step_in_place(self, iq: torch.Tensor):
        """One block with its carries written into the state's buffers:
        ``(audio, latest raw spectrum row [2, fft_size], latest_db)``."""
        new_state, audio, spectra = self._block(iq)
        carry(self.state, new_state)
        raw = spectra[:, -1, :]
        return audio, raw, spectrum_db(raw)

    def _graphs_for(self, shape) -> ServingGraphs:
        """The graph set for the current key, made where it changed."""
        key = self.graph_key()
        if self._graphs is None or self._graphs.key != key:
            self._graphs = ServingGraphs(self, key, shape, self._graphs)
        return self._graphs

    def _to_device(self, iq_planes: np.ndarray) -> torch.Tensor:
        """The block on the device, through a pinned staging buffer."""
        host = np.ascontiguousarray(iq_planes, dtype=np.float32)
        if self.device.type != "cuda":
            return torch.from_numpy(host).to(self.device)
        stage = self._staging.get(host.shape)
        if stage is None:
            stage = self._staging[host.shape] = [
                [torch.empty(host.shape, dtype=torch.float32,
                             pin_memory=True) for _ in range(2)],
                [None, None], 0]
        bufs, copied, slot = stage
        stage[2] = slot ^ 1
        if copied[slot] is not None:
            # its last copy has finished. On the one stream that copy came
            # after the step of three blocks back, so this wait also bounds
            # the dispatch queue: the host never runs more than about three
            # steps ahead of the card.
            copied[slot].synchronize()
        bufs[slot].numpy()[...] = host
        iq = torch.empty(host.shape, dtype=torch.float32, device=self.device)
        iq.copy_(bufs[slot], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        copied[slot] = event
        return iq

    def _swap_pending(self, audio, latest_db):
        result = self._pending
        self._pending = (audio, latest_db)
        return result

    def step_device(self, iq: torch.Tensor):
        """One block already on the device, outside the host contract:
        ``(audio, latest raw spectrum row, latest_db)`` of this block, on
        graphs the slot's outputs (valid until the call after next)."""
        if self.graphed():
            return self._graphs_for(iq.shape).serve_device(self, iq)
        return self._step_in_place(iq)

    def process_host(self, iq_planes: np.ndarray):
        if self.graphed():
            host = np.ascontiguousarray(iq_planes, dtype=np.float32)
            audio, _, latest_db = self._graphs_for(host.shape).serve(self,
                                                                     host)
        else:
            audio, _, latest_db = self._step_in_place(
                self._to_device(iq_planes))
        return self._swap_pending(audio, latest_db)

    def step_blocks(self, iq: torch.Tensor):
        """``iq [k, 2, block_frames]`` on the device through
        :meth:`step_device` in order: ``(audio [k, C, audio_frames]`` (a
        copy of its own), the last block's ``latest_db)``."""
        audio = None
        for j in range(iq.shape[0]):
            a, _, latest_db = self.step_device(iq[j])
            if self.audio_time_major:
                a = a.T
            if audio is None:
                audio = a.new_empty((iq.shape[0],) + tuple(a.shape))
            audio[j].copy_(a)
        return audio, latest_db

    def process_host_many(self, blocks: np.ndarray):
        """Catch-up path: a ``[k, 2, block_frames]`` backlog goes to the
        device as ONE pinned copy and through :meth:`step_blocks` (on
        graphs, ``k`` replays of the serving graphs). Same double-buffered
        contract as :meth:`process_host`; the previous result handed back
        may hold per-block audio or ``[k, C, audio_frames]``."""
        return self._swap_pending(*self.step_blocks(self._to_device(blocks)))

    def flush(self):
        result = self._pending
        self._pending = None
        return result

    def process_host_sync(self, iq_planes: np.ndarray):
        out = self.process_host(iq_planes)
        tail = self.flush()
        return tail if out is None else out

    def reset(self) -> None:
        self.load_state(self._init_state())
        self._pending = None


class FrontEndPipeline(HostPipeline):
    """The direct engine's pipeline: :func:`frontend_step_serving` behind
    the :class:`HostPipeline` interface; audio ``[C, audio_frames]``."""

    def __init__(self, cfg: ChainConfig, params: FrontEndParams,
                 graph: bool = True):
        super().__init__(cfg, params, params.rx.phase_step.device, graph)

    def _init_state(self) -> FrontEndState:
        return init_state(self.cfg, self.device)

    def _block(self, iq):
        return frontend_step(self.cfg, self.params, self.state, iq)
