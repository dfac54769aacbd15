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

import contextlib
import functools

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
    grow_state,
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


class Outputs(tuple):
    """One block's ``(audio, latest_db)`` as :meth:`HostPipeline.
    process_host` hands it back, and in ``ready`` for each card its step ran
    on ``(event, copy stream)``: an event recorded on the card's serving
    stream just after the block's step, and the card's copy stream (empty
    off the card). ``time_major``: the audio's layout, as the pipeline that
    made it says (a tensor ``[audio_frames, C]`` where True, else ``[C,
    audio_frames]`` or a backlog's ``[blocks, C, audio_frames]``; a sharded
    engine's :class:`..parallel.sharded.ShardedAudio` knows its own). The
    fan-out reads the block's rows behind that event (:meth:`select_rows`),
    not behind whatever the serving stream queued since."""

    def __new__(cls, audio, latest_db, ready=None, time_major=False):
        out = super().__new__(cls, (audio, latest_db))
        out.ready = ready or {}
        out.time_major = time_major
        return out

    @property
    def channels(self) -> int:
        """The block's width."""
        audio = self[0]
        if not isinstance(audio, torch.Tensor):
            return audio.channels
        return audio.shape[-1] if self.time_major else audio.shape[-2]

    def select_rows(self, rows) -> "SelectedRows":
        """The channels ``rows`` of the block's audio on their way to the
        host, gathered on each card behind the block's own step
        (:class:`SelectedRows`)."""
        audio = self[0]
        if not isinstance(audio, torch.Tensor):
            return audio.select_rows(rows, self.ready)
        return SelectedRows([(audio, rows, None)], self.time_major,
                            ready=self.ready)


@functools.lru_cache(maxsize=256)
def row_index(rows: tuple, device: torch.device, stream=None) -> torch.Tensor:
    """``rows`` as an index on ``device``, kept (the subscribed rows change
    rarely): to the card from pinned memory on ``stream`` (the current one
    where None; each stream that gathers keeps its own) without a wait (a
    blocking copy would hold the calling thread until everything queued on
    the stream has run)."""
    idx = torch.tensor(rows, dtype=torch.int64)
    if device.type != "cuda":
        return idx
    with torch.cuda.stream(stream):
        return idx.pin_memory().to(device, non_blocking=True)


def copy_to_host(tensors, device: torch.device, stream=None):
    """Queue a copy of each of ``tensors`` (on ``device``) into pinned host
    memory on ``stream`` (the device's current one where None), without a
    wait: ``(the host tensors, an event recorded after the copies)``; off
    the card the tensors themselves and None."""
    if device.type != "cuda":
        return list(tensors), None
    stream = stream or torch.cuda.current_stream(device)
    hosts = []
    with torch.cuda.stream(stream):
        for t in tensors:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            hosts.append(host)
    copied = torch.cuda.Event()
    copied.record(stream)
    return hosts, copied


@contextlib.contextmanager
def behind(card, sources):
    """Queue the body's reads of a block's outputs on the card's copy
    stream, behind the block's own step and nothing later.

    ``card``: the card's ``(event, copy stream)`` of :attr:`Outputs.ready`,
    or None, where the body runs on the current stream in its order. The
    copy stream waits on the event, not on the serving stream, which by
    then holds the next block's step. ``sources`` (the outputs the body
    reads, made on the serving stream) are kept from reuse until the copy
    stream has read them. After the body, the serving stream waits on the
    card for what the body queued before it runs anything queued later
    (the replay that rewrites those outputs comes two blocks on); the
    calling thread does not wait."""
    if card is None:
        yield
        return
    event, stream = card
    serving = torch.cuda.current_stream(stream.device)
    stream.wait_event(event)
    for t in sources:
        t.record_stream(stream)
    with torch.cuda.stream(stream):
        yield
    read = torch.cuda.Event()
    read.record(stream)
    serving.wait_event(read)


class SelectedRows:
    """Some channels of a block's audio, copied out of its pieces on their
    devices (one ``index_select`` a piece), so the pieces may be rewritten
    after it, and on the card queued for the host (one copy into pinned
    memory a piece, then an event a card) without a wait; :meth:`to_host`
    waits for them.

    ``pieces``: ``(tensor, its rows to take, place)``, the channels on the
    tensor's axis -2 (axis -1 where ``time_major``). ``place`` indexes the
    host array of ``shape`` that the piece's rows fill; None for one piece
    that is the whole answer (one card's audio), whose host rows
    :meth:`to_host` returns as they are. ``ready``: the block's
    :attr:`Outputs.ready`. Each card named there gathers its pieces on its
    copy stream behind the block's own step (:func:`behind`), and the
    copies to the host follow on that stream, so no later block's gather,
    queued there behind that block's step, comes between the two;
    elsewhere both run on the current stream, in its order. Off the card
    the gathered tensors are the answer."""

    def __init__(self, pieces, time_major: bool = False, shape=None,
                 ready=None):
        self.shape = shape
        #: the cards gathered behind their ready events: device -> (event,
        #: copy stream)
        self.ready = {}
        #: each card's event after its copies to the host
        self.copied = []
        #: ``(place, the rows on the host)``
        self.picks = []
        for dev in dict.fromkeys(t.device for t, _, _ in pieces):
            card = (ready or {}).get(dev)
            stream = card[1] if card else None
            on = [x for x in pieces if x[0].device == dev]
            with behind(card, [t for t, _, _ in on]):
                sels = [(t.movedim(-1, -2) if time_major else t).index_select(
                    -2, row_index(tuple(rows), dev, stream))
                    for t, rows, _ in on]
            hosts, copied = copy_to_host(sels, dev, stream)
            self.picks += [(place, host)
                           for (_, _, place), host in zip(on, hosts)]
            if copied is not None:
                self.copied.append(copied)
            if card:
                self.ready[dev] = card

    def is_ready(self) -> bool:
        """Whether every card's step of the block had ended (a query, no
        wait); True where no card's ready event was given."""
        return all(event.query() for event, _ in self.ready.values())

    def to_host(self) -> np.ndarray:
        """The rows on the host once every card's copies have ended:
        ``[k, af]`` for one block, ``[blocks, k, af]`` for several."""
        for copied in self.copied:
            copied.synchronize()
        if self.shape is None:
            [(_, host)] = self.picks
            return host.numpy()
        out = np.empty(self.shape, np.float32)
        for place, host in self.picks:
            out[place] = host.numpy()
        return out


class HostPipeline:
    """The double-buffered host interface of both engines' pipelines.

    :meth:`process_host` copies a ``[2, N]`` float32 numpy block through a
    pinned staging buffer to the device without blocking, runs the serving
    step on the current CUDA stream and returns the PREVIOUS call's
    ``(audio, latest_db [fft_size])`` as device tensors (None on the first
    call), an :class:`Outputs` whose ``ready`` holds an event recorded just
    after that call's step on each card, with the card's copy stream, and
    whose :meth:`Outputs.select_rows` takes listened rows to the host
    behind it; :meth:`flush` returns the last one. :meth:`process_host_many`
    does the same for a backlog ``[k, 2, N]`` (audio ``[k, C,
    audio_frames]``). Two staging buffers alternate, and a buffer is
    refilled only after the copy that last read it has finished. Not
    thread-safe: one thread drives it.

    A block is timed where the caller hands it a timing-event triple
    ``(the card's current stream, start, end)`` for each of
    :meth:`cards` in :attr:`step_events` before the call: the pipeline
    records each card's pair around its own share of the block and takes
    them (one card: the start before the block's H2D copy, the end after
    its step).

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
    time_major = False
    #: what a graph is made with (a test may put a stand-in here)
    graph_class = CudaStepGraph
    #: on the card, why the tail runs plain where no option asks for it;
    #: None where the kernels serve, on the CPU and on the direct engine
    plain_tail = None
    #: whether ``update_params_slots`` takes an incremental scatter of
    #: the dirty slots' columns
    scatters_slots = False
    #: the host's stamps of the last block's first and last card's launch
    #: where a block is a round over several cards; None where it is one
    #: card's
    launched = None

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
        #: each card's copy stream (``_ready``), made at its first block
        self._copy_streams: dict = {}
        #: the next block's timing-event triples, one a card of
        #: :meth:`cards`, taken by the block; None leaves it untimed
        self.step_events = None
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

    def cards(self) -> list:
        """The CUDA devices a block's step runs on."""
        return [self.device] if self.device.type == "cuda" else []

    def _ready(self) -> dict:
        """For each card, an event recorded on its current (serving) stream
        after the step just queued there, with the card's copy stream. The
        copy streams take the high priority, so that a block's small
        gather runs among the next step's kernels as soon as the card has
        room, and no capture stream of the graphs is ever one of them (those
        come from the pool of the default priority)."""
        ready = {}
        for dev in self.cards():
            stream = self._copy_streams.get(dev)
            if stream is None:
                stream = self._copy_streams[dev] = torch.cuda.Stream(
                    dev, priority=-1)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            ready[dev] = (event, stream)
        return ready

    def _swap_pending(self, audio, latest_db, time_major=False):
        result = self._pending
        self._pending = Outputs(audio, latest_db, self._ready(), time_major)
        return result

    def _timed(self):
        """The block's timing events (:attr:`step_events`, taken), the start
        recorded on the card's stream before anything of the block:
        ``(stream, start, end)``, or None where it goes untimed. Like the
        staging copies' events they are recorded outside
        ``.graph.LAUNCH_LOCK``: only a graph launch deadlocked against a
        profiler's stop."""
        events, self.step_events = self.step_events, None
        if not events:
            return None
        stream, start, _ = events[0]
        start.record(stream)
        return events[0]

    def step_device(self, iq: torch.Tensor):
        """One block already on the device, outside the host contract:
        ``(audio, latest raw spectrum row, latest_db)`` of this block, on
        graphs the slot's outputs (valid until the call after next)."""
        if self.graphed():
            return self._graphs_for(iq.shape).serve_device(self, iq)
        return self._step_in_place(iq)

    def process_host(self, iq_planes: np.ndarray):
        timed = self._timed()
        if self.graphed():
            host = np.ascontiguousarray(iq_planes, dtype=np.float32)
            audio, _, latest_db = self._graphs_for(host.shape).serve(self,
                                                                     host)
        else:
            audio, _, latest_db = self._step_in_place(
                self._to_device(iq_planes))
        if timed:
            timed[2].record(timed[0])
        return self._swap_pending(audio, latest_db, self.time_major)

    def step_blocks(self, iq: torch.Tensor):
        """``iq [k, 2, block_frames]`` on the device through
        :meth:`step_device` in order: ``(audio [k, C, audio_frames]`` (a
        copy of its own), the last block's ``latest_db)``."""
        audio = None
        for j in range(iq.shape[0]):
            a, _, latest_db = self.step_device(iq[j])
            if self.time_major:
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
        timed = self._timed()
        out = self.step_blocks(self._to_device(blocks))
        if timed:
            timed[2].record(timed[0])
        return self._swap_pending(*out)

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

    def carry_state_from(self, old) -> bool:
        """Carry the DSP state of ``old``, the narrower pipeline a growth
        replaces, into this one's buffers (new slots start from zeros, and
        its graphs stay valid); whether it could. Here it cannot: the
        state restarts fresh."""
        return False


class FrontEndPipeline(HostPipeline):
    """The direct engine's pipeline: :func:`frontend_step_serving` behind
    the :class:`HostPipeline` interface; audio ``[C, audio_frames]``."""

    def __init__(self, cfg: ChainConfig, params: FrontEndParams,
                 graph: bool = True):
        super().__init__(cfg, params, params.rx.phase_step.device, graph)

    def _init_state(self) -> FrontEndState:
        return init_state(self.cfg, self.device)

    def carry_state_from(self, old) -> bool:
        if not isinstance(old, FrontEndPipeline):
            return False
        self.load_state(grow_state(old.state, self.cfg.num_channels))
        return True

    def _block(self, iq):
        return frontend_step(self.cfg, self.params, self.state, iq)
