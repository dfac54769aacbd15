"""Topology / session management: front ends, receivers, the block pump
(port of ``webradio_tpu.radio``).

The reference models this as graph objects plus global registries
(src/radio.{h,cxx}): a ``FrontEnd`` owns one tuner and a spectrum sink and a
set of attached ``Receiver`` chains; ``Radio::run()`` pumps every tuner once
per loop. Here a FrontEnd owns one *pipeline* (the direct or the
channelized serving step on the card) with a fixed channel capacity;
Receivers are control-plane slot views whose settings become the step's
parameters.

Control writes land between blocks. An HTTP thread that attaches,
detaches or retunes a receiver designs the new parameters on the host and
QUEUES them; the pump thread applies every queued write at the top of
:meth:`FrontEnd.run_once`, before it dispatches the next step. The
channelized engine's slot scatter writes its tensors in place, so a write
made from another thread while a step is being dispatched could give one
block half old and half new parameters; the queue rules that out.

Device work never waits on the pump thread for the whole device: the
pump gathers the subscribed rows of each block's audio (one
``index_select`` over an index it keeps on the device and copies there
without a wait when the rows change) and a copy of its spectrum row on
its stream as it
publishes the block, so both are ordered before the replay that rewrites
those outputs (each block is a CUDA graph replay into fixed outputs,
``pipeline.graph``); audio leaves the card only in the fan-out thread (one
copy of the gathered rows into pinned host memory, a wait on a CUDA event
recorded after that copy); the step's device time is read from two timing
events around it once they have completed (the pump polls them at its
next blocks), and the spectrum row is copied to the host on HTTP demand.
Everything runs on the current (default) CUDA stream, so each copy is
ordered after the step that made its input.

Every block is stamped in the front end's flight recorder (``trace``), by
its id from the ring on: the pump's spans around each call into the
control plane, the pipeline, the publish and the hand-off, and the
fan-out's around its fetch and delivery, with counters of each.

``engine="sharded"`` spreads a front end over a mesh of devices
(``parallel.sharded_channelized``); ``multihost=True`` runs that engine's
pump in lockstep on every rank of a ``torch.distributed`` group (see
:meth:`FrontEnd._run_once_multihost`).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import threading
import time

import numpy as np
import torch

from . import require_cuda, trace
from .io.ring import BlockRing, CaptureThread
from .io.tuner import Tuner
from .ops.demod import MODES
from .pipeline.channelized import (
    ChannelizedConfig,
    ChannelizedPipeline,
    grow_channelized_state,
    make_channelized_params,
)
from .parallel import mesh as pmesh
from .parallel import multihost as phost
from .parallel.sharded import SelectedRows, ShardedAudio
from .parallel.sharded_channelized import ShardedChannelizedFrontEnd
from .pipeline.frontend import FrontEndPipeline
from .pipeline.state import ChainConfig, grow_state, make_receiver_params

#: "auto" engine switches to the shared polyphase filterbank once the
#: channel batch is wide enough that per-channel wideband mixing dominates
CHANNELIZED_AUTO_THRESHOLD = 16

#: blocks a front end's ingest ring holds on the card (682.7 ms at stock
#: rates): deep enough to ride out a 200-570 ms stall of the pump (a
#: profiler's stop holds it in a CUDA call). The pump serves the whole
#: backlog at its next block (:meth:`FrontEnd.run_once`), a graph replay a
#: block, several times faster than real time, so no backlog stands
RING_BLOCKS = 16
#: the same on the CPU, the reference's depth (rtlsdrtuner.cxx:33-34): an
#: eager CPU pump may keep barely real time, and a deeper ring then turns
#: a start-up backlog into one that stands (a ring of 16 kept one for over
#: 10 s under a loaded test run); no CUPTI stop stalls it there
CPU_RING_BLOCKS = 4

#: hand-offs (one run_once's gathered audio rows) the fan-out worker may
#: hold while it fetches; overflow drops OLDEST (counted)
FANOUT_QUEUE_DEPTH = 2

#: a multihost waterfall poll keeps the per-block spectrum gather on for
#: this long (the gather is a collective on every rank)
SPECTRUM_WANTED_S = 2.0

#: multihost rounds whose (round, source block index) a front end keeps
#: (:attr:`FrontEnd.served`): 10.9 s at stock rates
SERVED_KEPT = 256

log = logging.getLogger(__name__)


def _to_planes(block: np.ndarray) -> np.ndarray:
    """Sample block -> contiguous float32 ``[2, N]`` planes.

    Sources deliver complex64 ``[N]`` (Python drivers) or ready ``[2, N]``
    float32 planes (native capture paths). Complex input converts through
    the port's native deinterleaver when it builds, else numpy."""
    if block.ndim == 2:
        return np.ascontiguousarray(block, np.float32)
    from .io import native

    if native.available():
        return native.convert_planes(block)
    # complex64 is interleaved (re, im) float32 in memory
    return np.ascontiguousarray(block.view(np.float32).reshape(-1, 2).T)


def _row_index(rows, device: torch.device) -> torch.Tensor:
    """``rows`` as an index on ``device``; to the card from pinned memory
    without a wait (a blocking copy would hold the calling thread until
    everything queued on the stream has run)."""
    idx = torch.tensor(rows, dtype=torch.int64)
    if device.type != "cuda":
        return idx.to(device)
    return idx.pin_memory().to(device, non_blocking=True)


def _gather_rows(audio: torch.Tensor, rows, time_major: bool = False,
                 idx: torch.Tensor | None = None) -> torch.Tensor:
    """ONE ``index_select`` of the subscribed receivers' rows on the
    device: ``[k, audio_frames]`` of one block, ``[blocks, k,
    audio_frames]`` of a catch-up's ``[blocks, C, audio_frames]``.
    ``time_major`` is the channelized serving layout (``[audio_frames,
    C]``, channels are columns). ``idx`` is ``rows`` on the device where
    the caller keeps it."""
    if idx is None:
        idx = _row_index(rows, audio.device)
    src = audio.movedim(-1, -2) if time_major else audio
    return src.index_select(-2, idx)


def _rows_to_host(sel) -> np.ndarray:
    """Gathered rows on the host: ONE copy into pinned host memory, then a
    wait on a CUDA event recorded after it, in the calling (fan-out)
    thread. A sharded engine's rows
    (:class:`.parallel.sharded.SelectedRows`) come from their devices."""
    if isinstance(sel, SelectedRows):
        return sel.to_host()
    if sel.device.type != "cuda":
        return sel.numpy()
    host = torch.empty(sel.shape, dtype=sel.dtype, pin_memory=True)
    host.copy_(sel, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host.numpy()


def _fetch_audio_rows(audio, rows, time_major: bool = False) -> np.ndarray:
    """The subscribed receivers' audio rows on the host
    (:func:`_gather_rows`, then :func:`_rows_to_host`)."""
    if isinstance(audio, ShardedAudio):
        return audio.fetch_rows(rows)
    return _rows_to_host(_gather_rows(audio, rows, time_major))


class CapacityError(RuntimeError):
    """Attach past capacity where growth cannot run: under multihost
    serving, where a growth build would run collectives off the lockstep
    schedule (the HTTP layer answers it with 409 Conflict)."""


#: "argument not provided" sentinel for partial control writes
UNSET = object()

_uuid_lock = threading.Lock()
_uuid_counters: dict[str, int] = {}


def _next_uuid(kind: str) -> str:
    """4-hex-digit counter UUIDs like the reference (radio.cxx:35-40),
    counted per kind so the first tuner AND the first receiver are both
    "0000" (what the reference UI hardcodes)."""
    with _uuid_lock:
        n = _uuid_counters.get(kind, 0)
        _uuid_counters[kind] = n + 1
        return f"{n:04x}"


class DropOldestQueue:
    """Bounded producer/consumer queue, drop-OLDEST on overflow with a drop
    counter. ``put`` never blocks; ``get`` blocks until an item, close, or
    timeout. After ``close()``, queued items still drain."""

    def __init__(self, depth: int):
        self.depth = int(depth)
        self.dropped = 0
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False

    def put(self, item) -> None:
        with self._cv:
            if self._closed:
                return
            if len(self._q) >= self.depth:
                self._q.popleft()
                self.dropped += 1
            self._q.append(item)
            self._cv.notify()

    def get(self, timeout: float | None = None):
        """Next item; None when closed-and-drained or on timeout."""
        with self._cv:
            while not self._q:
                if self._closed:
                    return None
                if not self._cv.wait(timeout):
                    return None
            return self._q.popleft()

    def clear(self) -> None:
        with self._cv:
            self._q.clear()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed


class Handoff(list):
    """One ``run_once``'s gathered audio for the fan-out: the ``(gathered,
    rows)`` pairs :meth:`FrontEnd._publish` returned, and in ``ids`` the
    block id of each pair (None where the block has none)."""

    def __init__(self):
        super().__init__()
        self.ids: list = []

    def add(self, bid, pairs) -> None:
        self.extend(pairs)
        self.ids.extend([bid] * len(pairs))


class SinkWriter:
    """Decouples a blocking local audio sink from the fan-out: rows are
    enqueued (never blocking, drop-oldest) and a writer thread owns every
    call into the sink, including the final ``close``."""

    #: queue bound in audio blocks (~42.7 ms each at stock rates)
    MAX_BLOCKS = 8

    def __init__(self, sink, name: str):
        self.sink = sink
        self.failed = False
        self._q = DropOldestQueue(self.MAX_BLOCKS)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"sink-{name}")
        self._thread.start()

    @property
    def dropped(self) -> int:
        return self._q.dropped

    def write(self, row) -> None:
        if not self.failed:
            self._q.put(row)

    def _run(self) -> None:
        while True:
            row = self._q.get()
            if row is None:  # closed and drained
                break
            try:
                self.sink.write(row)
            except Exception:
                log.exception("audio sink write failed; unbinding")
                self.failed = True
                self._q.clear()
                break
        try:
            self.sink.close()
        except Exception:
            log.debug("audio sink close failed", exc_info=True)

    def close(self) -> None:
        self._q.close()


class Receiver:
    """One demodulation channel: a control-plane view of a pipeline slot.

    Defaults mirror radio.cxx:78-82: 80 kHz channel passband, 8 kHz audio
    passband, AM.
    """

    def __init__(self):
        self.uuid = _next_uuid("receiver")
        self.if_frequency = 0
        self.if_bandwidth = 80_000
        self.af_bandwidth = 8_000
        # both functional here (dB); the reference surfaces them as
        # constant 0 stubs (receiverhandler.cxx:118-119)
        self.af_gain = 0
        # dB threshold, or None = gate disabled (the default)
        self.squelch_threshold = None
        self.demodulator = "AM"
        # optional local consumer of this receiver's audio rows (an object
        # with write(row) and close()); written by the fan-out worker under
        # _sink_lock
        self.audio_sink = None
        #: the topology's ``audio_sink`` spec it was bound from (the
        #: checkpoint writes it back), or None
        self.audio_sink_spec: str | None = None
        self._sink_lock = threading.Lock()
        self.front_end: FrontEnd | None = None
        Radio.receivers[self.uuid] = self

    def set_front_end(self, fe: FrontEnd | None) -> None:
        if self.front_end is not None:
            self.front_end._detach(self)
            self.front_end = None
        if fe is not None:
            fe._attach(self)
            self.front_end = fe

    def update(self, *, if_frequency=None, if_bandwidth=None,
               af_bandwidth=None, demodulator=None, af_gain=None,
               squelch_threshold=UNSET) -> bool:
        """Apply a control write (PUT /receivers/<id>,
        receiverhandler.cxx:125-140). Returns False on a bad field.

        ``squelch_threshold``: absent = unchanged, ``None`` = gate off, a
        dB value gates. Validate-then-apply: every field is checked before
        any changes, so a rejected write leaves the receiver as it was.
        """
        staged = {}
        try:
            if if_frequency is not None:
                staged["if_frequency"] = int(if_frequency)
            if if_bandwidth is not None:
                staged["if_bandwidth"] = int(if_bandwidth)
            if af_bandwidth is not None:
                staged["af_bandwidth"] = int(af_bandwidth)
            if af_gain is not None:
                staged["af_gain"] = int(af_gain)
            if squelch_threshold is not UNSET:
                staged["squelch_threshold"] = (
                    None if squelch_threshold is None
                    else float(squelch_threshold))
        except (TypeError, ValueError):
            return False
        if staged.get("if_bandwidth", 1) <= 0:
            return False
        if staged.get("af_bandwidth", 1) <= 0:
            return False
        if demodulator is not None:
            if demodulator not in MODES:
                return False
            staged["demodulator"] = demodulator
        fe = self.front_end
        if fe is None:
            for field, value in staged.items():
                setattr(self, field, value)
            return True
        # under the front end's control lock, so the fields and the
        # parameters built from them are queued in the same order
        with fe._ctrl_lock:
            for field, value in staged.items():
                setattr(self, field, value)
            fe.rebuild_params(slots=fe.slots_of(self))
        return True

    def close(self) -> None:
        self.set_front_end(None)
        with self._sink_lock:
            sink, self.audio_sink = self.audio_sink, None
        if sink is not None:
            try:
                sink.close()
            except Exception:
                log.debug("receiver %s: audio sink close failed", self.uuid,
                          exc_info=True)
        Radio.receivers.pop(self.uuid, None)


class FrontEnd:
    """One tuner + spectrum + up to ``capacity`` receiver channels on one
    device, or on a mesh of devices (``engine="sharded"``).

    ``capacity`` is the step's channel batch width; receivers occupy slots,
    and empty slots run as muted AM channels at IF 0 (their audio is never
    consumed). Attaching past capacity doubles the width: the wider
    pipeline is built off the pump thread and swapped in between blocks.
    """

    def __init__(self, tuner: Tuner, cfg: ChainConfig | None = None,
                 capacity: int = 4, engine: str = "auto",
                 fir_precision: str = "highest",
                 pfb_precision: str = "highest",
                 multihost: bool = False,
                 device: torch.device | str | None = None):
        """``engine``: "direct" (per-channel NCO + FIR, the reference
        topology), "channelized" (shared polyphase filterbank, the scalable
        path), "sharded" (the channelized engine over a ``(time, chan)``
        mesh of :func:`.parallel.mesh.visible_devices`, factored by
        :func:`.parallel.mesh.mesh_shape_for`) or "auto" (channelized from
        CHANNELIZED_AUTO_THRESHOLD channels). ``fir_precision``: the
        channelized engine's FIR tier (every tier runs float32 on the
        card). ``pfb_precision``: the filterbank product's tier
        (``ops.channelizer``). ``multihost``: run the sharded engine's pump
        in lockstep on every rank of the process group (requires
        ``engine="sharded"``): rank 0 broadcasts the round's control
        writes, each rank ingests its own time slice, the gathers are
        collectives, and only rank 0 serves HTTP. Without a process group
        the same path runs with identity collectives. ``device``: None is
        the CUDA device, and an error where there is none."""
        if engine not in ("auto", "direct", "channelized", "sharded"):
            raise ValueError(f"unknown engine {engine!r}")
        self.multihost = bool(multihost)
        if self.multihost and engine != "sharded":
            raise ValueError("multihost serving requires engine='sharded'")
        self.device = torch.device(device) if device is not None \
            else require_cuda()
        self.uuid = _next_uuid("frontend")
        self.tuner = tuner
        self.engine = engine
        self.fir_precision = fir_precision
        self.pfb_precision = pfb_precision
        base = cfg or ChainConfig()
        self.cfg = dataclasses.replace(base, num_channels=capacity)
        # the rate the device actually runs at (rtlsdrtuner.cxx:226-228):
        # the DSP grid stays on the nominal rates, NCO/bin plans follow it
        self.actual_sample_rate = self.cfg.sample_rate
        self._slots: list[Receiver | None] = [None] * capacity
        self.pipeline: FrontEndPipeline | ChannelizedPipeline | None = None
        # control writes: designed under _ctrl_lock (one writer at a time,
        # so they queue in the order their settings were made), queued
        # under _queue_lock, and applied by the pump at the top of run_once
        # (see apply_control), which never waits for a design
        self._ctrl_lock = threading.RLock()
        self._queue_lock = threading.Lock()
        self._ctrl: list = []
        # growth: _growth_lock guards the slot table's width, the grow
        # thread and the pipeline waiting to be swapped in
        self._growth_lock = threading.Lock()
        self._grow_thread: threading.Thread | None = None
        self._pending_swap = None
        # graph counts of the pipelines swapped out by growth
        self._retired_graph_stats: dict[str, int] = {}
        # the subscribed rows of the last publish, their device and their
        # index there: made again only when they change
        self._rows_on_device: tuple = ((), None, None)
        #: this front end's flight recorder (``trace``): every block, by id
        self.trace = trace.recorder(self.uuid)
        self.ring = BlockRing(self.ring_blocks, self.trace)
        # the block whose outputs the pipeline holds (it hands them back
        # at the next call); the step timing events not yet read, and
        # those free for another block
        self._inflight_id = None
        self._step_events: collections.deque = collections.deque()
        self._free_events: list = []
        self._step_stream = None
        # what the last _deliver_rows did, for the fan-out's recorder row:
        # its start and end, encode ns, consumers pushed, consumers whose
        # queue dropped the block, the deepest consumer queue
        self._delivery = (0, 0, 0, 0, 0, 0)
        self._capture: CaptureThread | None = None
        self.running = False
        # latest spectrum dB row (on the device) for HTTP readers
        self._spec_lock = threading.Lock()
        self._spectrum_db: torch.Tensor | None = None
        self.block_count = 0
        self._fanout = DropOldestQueue(FANOUT_QUEUE_DEPTH)
        self._fanout_thread: threading.Thread | None = None
        #: (what failed, the error) of the fan-out worker or of a growth
        #: build; the next run_once raises it
        self._fault: tuple[str, BaseException] | None = None
        # uniform (if_bw, af_bw) the resident shared FIR kernels were
        # designed from at the last FULL build; the incremental scatter
        # requires dirty slots to keep exactly these
        self._shared_bw: tuple | None = None
        # multihost: slots written since the last round (rank 0), every
        # rank's mirror of the slot settings, the round counter, the time
        # of the last waterfall poll
        self._mh_dirty: set[int] = set()
        self._mh_settings: list | None = None
        self._mh_round = 0
        self._mh_spec_wanted = float("-inf")
        #: multihost: blocks read and passed over to reach the block the
        #: ranks agreed on (drops, in :attr:`dropped_blocks`), and the
        #: (round, source block index) of the last SERVED_KEPT rounds
        self.skipped_blocks = 0
        self.served: collections.deque = collections.deque(
            maxlen=SERVED_KEPT)
        Radio.front_ends[self.uuid] = self

    @property
    def ring_blocks(self) -> int:
        """The depth of this front end's ingest ring."""
        return RING_BLOCKS if self.device.type == "cuda" else CPU_RING_BLOCKS

    @property
    def dropped_blocks(self) -> int:
        """Blocks lost before the step: the ingest ring's drops, and under
        multihost the blocks passed over to serve the agreed block."""
        return self.ring.dropped_blocks + self.skipped_blocks

    # ---- receiver slots -------------------------------------------
    @property
    def receivers(self) -> dict[str, Receiver]:
        return {r.uuid: r for r in self._slots if r is not None}

    def _attach(self, rx: Receiver) -> None:
        with self._ctrl_lock:
            for i, slot in enumerate(self._slots):
                if slot is None:
                    self._slots[i] = rx
                    self.rebuild_params(slots=[i])
                    return
            if self.multihost and self.running:
                raise CapacityError(
                    f"front end {self.uuid} is at capacity "
                    f"({self.cfg.num_channels}) and capacity growth is not "
                    "supported under multihost serving; restart with a "
                    "larger capacity")
            # grow: double the slot table. While live, the serving
            # pipeline keeps the old width and a thread builds the wider
            # one; the pump swaps it in between blocks with carried state
            with self._growth_lock:
                self._slots.extend([None] * len(self._slots))
                self.cfg = dataclasses.replace(self.cfg,
                                               num_channels=len(self._slots))
                self._slots[len(self._slots) // 2] = rx
                live = self.running and self.pipeline is not None
                if live and self._grow_thread is None:
                    self._grow_thread = threading.Thread(
                        target=self._grow_worker, daemon=True,
                        name=f"grow-{self.uuid}")
                    self._grow_thread.start()
                elif not live:
                    self.pipeline = None  # rebuilt at the new width below
            self.rebuild_params()

    def _detach(self, rx: Receiver) -> None:
        with self._ctrl_lock:
            cleared = []
            for i, slot in enumerate(self._slots):
                if slot is rx:
                    self._slots[i] = None
                    cleared.append(i)
            self.rebuild_params(slots=cleared or None)

    @property
    def fanout_dropped(self) -> int:
        """Fan-out queue overflow (device audio dropped before its consumer
        rows could be fetched) — /status."""
        return self._fanout.dropped

    def slots_of(self, rx: Receiver) -> list[int] | None:
        """Slot indices of ``rx``, or None when it is not attached (a
        control write racing a DELETE then takes the full rebuild)."""
        found = [i for i, s in enumerate(self._slots) if s is rx]
        return found or None

    # ---- parameters ------------------------------------------------
    def _use_channelized(self, width: int | None = None) -> bool:
        if self.engine in ("channelized", "sharded"):
            return True
        if self.engine == "direct":
            return False
        w = self.cfg.num_channels if width is None else width
        return w >= CHANNELIZED_AUTO_THRESHOLD

    def _slot_settings(self, width: int):
        """Control values of the first ``width`` slots; empty slots run as
        muted defaults with the first occupied slot's law."""
        fill_mode = next(
            (s.demodulator for s in self._slots[:width] if s is not None),
            "AM")
        ifs, ifbw, afbw, modes = [], [], [], []
        gains, squelches = [], []
        for slot in self._slots[:width]:
            if slot is None:
                ifs.append(0)
                ifbw.append(80_000)
                afbw.append(8_000)
                modes.append(fill_mode)
                gains.append(0)
                squelches.append(None)
            else:
                ifs.append(slot.if_frequency)
                ifbw.append(slot.if_bandwidth)
                afbw.append(slot.af_bandwidth)
                modes.append(slot.demodulator)
                gains.append(slot.af_gain)
                squelches.append(slot.squelch_threshold)
        return ifs, ifbw, afbw, modes, gains, squelches

    def _channelized_cfg(self, width: int) -> ChannelizedConfig:
        return ChannelizedConfig(
            sample_rate=self.cfg.sample_rate,
            channel_rate=self.cfg.channel_rate,
            audio_rate=self.cfg.audio_rate,
            block_frames=self.cfg.block_frames,
            num_channels=width,
            fft_size=self.cfg.fft_size,
            fir_precision=self.fir_precision,
            pfb_precision=self.pfb_precision,
            fir_design=self.cfg.fir_design,
        )

    def _make_params(self, width: int, settings=None):
        """Parameters for a ``width``-channel pipeline of the engine that
        width selects, on the front end's device (on the host for the
        sharded engine, which cuts them onto its positions)."""
        settings = settings or self._slot_settings(width)
        if self._use_channelized(width):
            return make_channelized_params(
                self._channelized_cfg(width), *settings,
                actual_sample_rate=self.actual_sample_rate,
                device="cpu" if self.engine == "sharded" else self.device)
        return make_receiver_params(
            dataclasses.replace(self.cfg, num_channels=width), *settings,
            actual_sample_rate=self.actual_sample_rate, device=self.device)

    def _build_pipeline(self, width: int, settings=None):
        """A fresh pipeline at ``width`` channels."""
        params = self._make_params(width, settings)
        if self.engine == "sharded":
            return ShardedChannelizedFrontEnd(
                self._channelized_cfg(width), params, self._mesh(width))
        if self._use_channelized(width):
            return ChannelizedPipeline(self._channelized_cfg(width), params)
        return FrontEndPipeline(
            dataclasses.replace(self.cfg, num_channels=width), params)

    def _mesh(self, width: int):
        """The sharded engine's mesh: :func:`.parallel.mesh.mesh_shape_for`
        over this rank's devices and its share of the block; across ranks
        the time axis spans them, each rank a run of whole time rows."""
        devices = pmesh.visible_devices(self.device)
        _, size = pmesh.world()
        t, c = pmesh.mesh_shape_for(len(devices), width,
                                    self.cfg.block_frames // size,
                                    self.cfg.fft_size)
        mesh = pmesh.make_mesh(t * size, c, devices)
        log.info("front end %s: sharded over a (time=%d, chan=%d) mesh, "
                 "this rank's devices %s", self.uuid, mesh.time, mesh.chan,
                 [str(d) for d in devices[:t * c]])
        return mesh

    def _note_shared_bw(self, width: int, settings=None) -> None:
        _, ifbw, afbw, *_ = settings or self._slot_settings(width)
        self._shared_bw = ((ifbw[0], afbw[0])
                           if len(set(ifbw)) == 1 and len(set(afbw)) == 1
                           else None)

    def rebuild_params(self, slots: list[int] | None = None) -> None:
        """Turn control-plane settings into the step's parameters, applied
        by the pump before its next block (:meth:`apply_control`).

        While a growth build is in flight the serving pipeline is narrower
        than the slot table; parameters are built at the serving width and
        the swap catches the new slots up. ``slots`` names the dirty slots
        when the caller knows them: on the channelized engine an
        INCREMENTAL scatter of just those columns is queued
        (:func:`..pipeline.channelized.scatter_params_slots`; at C=32,768 a
        full rebuild re-designs and re-uploads 84 MB of filterbank weights,
        the scatter ~3 KB), unless the change could alter the parameters'
        structure (a bandwidth that leaves the shared FIR kernels)."""
        with self._ctrl_lock:
            if self.pipeline is None:
                self.pipeline = self._build_pipeline(self.cfg.num_channels)
                self._note_shared_bw(self.cfg.num_channels)
                return
            pipe = self.pipeline
            width = pipe.cfg.num_channels
            if self.multihost and self.running:
                # every rank applies the round's writes together (see
                # _run_once_multihost): mark the slots for the next round
                self._mh_dirty.update(range(width) if slots is None
                                      else (s for s in slots if s < width))
                return
            if (slots
                    and isinstance(pipe, (ChannelizedPipeline,
                                          ShardedChannelizedFrontEnd))
                    and all(0 <= s < width for s in slots)
                    and self._shared_bw is not None):
                settings = self._slot_settings(width)
                ifbw, afbw = settings[1], settings[2]
                if all(ifbw[s] == self._shared_bw[0]
                       and afbw[s] == self._shared_bw[1] for s in slots):
                    sub = make_channelized_params(
                        dataclasses.replace(pipe.cfg,
                                            num_channels=len(slots)),
                        *([v[s] for s in slots] for v in settings),
                        actual_sample_rate=self.actual_sample_rate,
                        device="cpu")
                    idx = list(slots)
                    self._queue(pipe,
                                lambda p: p.update_params_slots(idx, sub))
                    return
            self._note_shared_bw(width)
            params = self._make_params(width)
            self._queue(pipe, lambda p: p.update_params(params))

    def _queue(self, pipe, apply) -> None:
        with self._queue_lock:
            self._ctrl.append((pipe, apply))

    def apply_control(self) -> None:
        """Apply the queued control writes to the serving pipeline, in the
        order they were made. Called by the pump thread between blocks (and
        before the first); a write built for a pipeline that has since
        been swapped out is dropped, since the swap rebuilds from the
        current settings."""
        with self._queue_lock:
            queued, self._ctrl = self._ctrl, []
        pipe = self.pipeline
        for target, apply in queued:
            if target is pipe:
                apply(pipe)

    # ---- lifecycle --------------------------------------------------
    def start(self) -> bool:
        if self.running:
            return True
        self.tuner.set_sample_rate(self.cfg.sample_rate)
        self.tuner.set_block_frames(self.cfg.block_frames)
        if self.multihost:
            # every rank's source starts at once: a paced source's block k
            # then comes due at the same time on every rank, so the ranks
            # can serve the same block with no ring holding the difference
            # of their start times (see _agreed_block)
            phost.barrier()
        if not self.tuner.start():
            log.error("front end %s: tuner failed to start", self.uuid)
            return False
        try:
            eff = self.tuner.effective_sample_rate
            if eff != self.actual_sample_rate:
                self.actual_sample_rate = eff
                if eff != self.cfg.sample_rate:
                    log.warning(
                        "front end %s: device sample rate %d Hz (requested "
                        "%d) — frequency plan follows the actual rate",
                        self.uuid, eff, self.cfg.sample_rate)
                if self.pipeline is not None:
                    self.rebuild_params()
            if self.pipeline is None:
                self.rebuild_params()
            self.apply_control()
            if self.multihost:
                return self._start_multihost()
            # one zero block through the step and the fan-out fetch before
            # capture starts: builds the CUDA kernels where the step runs
            # one (a build failure stops the start here), primes the
            # pinned staging buffers and the allocator, and on the card
            # captures the step's graphs (after the app's profiler warm)
            log.info("front end %s: warming pipeline", self.uuid)
            t0 = time.perf_counter()
            out = self.pipeline.process_host_sync(
                np.zeros((2, self.cfg.block_frames), np.float32))
            _fetch_audio_rows(out[0], [0], self.pipeline.audio_time_major)
            self.pipeline.reset()
            log.info("front end %s: pipeline warm in %.1fs", self.uuid,
                     time.perf_counter() - t0)
        except BaseException:
            self.tuner.stop()
            raise
        # block ids go on from those of the last ring
        self.ring = BlockRing(self.ring_blocks, self.trace,
                              first_id=self.trace.next_id)
        self._inflight_id = None
        self._capture = CaptureThread(self.tuner, self.ring)
        self._capture.start()
        self.running = True
        self._fault = None
        self._fanout = DropOldestQueue(FANOUT_QUEUE_DEPTH)
        self._fanout_thread = threading.Thread(
            target=self._fanout_worker, daemon=True,
            name=f"fanout-{self.uuid}")
        self._fanout_thread.start()
        self.started_monotonic = time.monotonic()
        self._blocks_at_start = self.block_count
        return True

    # ---- multihost (lockstep) serving ---------------------------------
    # Engine "sharded" with multihost=True: every rank runs this pump in
    # lockstep, because the sharded step and the gathers are collectives.
    # Rank 0 owns HTTP. At the top of each round it broadcasts the slots
    # written since the last round (width, subscribed rows, whether the
    # waterfall is watched, the tuner, and each written slot's six
    # settings) with a round counter; every rank, rank 0 too, then applies
    # the same writes to its mirror of the slot settings and the same
    # per-shard slot scatter (or, where a bandwidth leaves the shared FIR
    # kernels, the same full rebuild from the mirror). Capture is
    # pull-synchronous: each rank reads its block from its paced source,
    # the ranks agree on the block's index (_agreed_block), and each
    # ingests only its own time slice of that block.

    def _start_multihost(self) -> bool:
        pipe = self.pipeline
        width = pipe.cfg.num_channels
        self._mh_slice = phost.host_time_slice(self.cfg.block_frames,
                                               pipe.mesh)
        self._mh_settings = [list(v) for v in self._slot_settings(width)]
        self._mh_dirty = set()
        self._mh_round = 0
        self.served.clear()
        rank, size = pmesh.world()
        lo, hi = self._mh_slice
        log.info("front end %s: multihost warm (rank %d of %d, frames "
                 "[%d, %d) of %d)", self.uuid, rank, size, lo, hi,
                 self.cfg.block_frames)
        t0 = time.perf_counter()
        # on the card: the warm block, then the graphs' captures
        out = pipe.process_host_sync(np.zeros((2, hi - lo), np.float32))
        phost.gather_to_host(out[1][None])  # the gather path, warm
        phost.gather_to_host(out[0].fetch_rows([0]), dim=-1)
        pipe.reset()
        log.info("front end %s: multihost pipeline warm in %.1fs", self.uuid,
                 time.perf_counter() - t0)
        self.running = True
        self._fault = None
        self.started_monotonic = time.monotonic()
        self._blocks_at_start = self.block_count
        return True

    def _control_blob(self) -> dict:
        """Rank 0's control round: what every rank needs to step and
        publish this block the same way."""
        from .web.audiostream import AudioStreamManager

        with self._ctrl_lock:
            width = self.pipeline.cfg.num_channels
            settings = self._slot_settings(width)
            dirty, self._mh_dirty = sorted(self._mh_dirty), set()
            rows = [i for i, rx in enumerate(self._slots[:width])
                    if rx is not None
                    and (AudioStreamManager.has_consumers(rx.uuid)
                         or rx.audio_sink is not None)]
        return {
            "round": self._mh_round + 1,
            "width": width,
            "rows": rows,
            "want_spectrum": (time.monotonic() - self._mh_spec_wanted
                              < SPECTRUM_WANTED_S),
            "tuner": {"centre_frequency": self.tuner.centre_frequency,
                      "agc": self.tuner.agc, "gain_db": self.tuner.gain_db,
                      "offset_ppm": self.tuner.offset_ppm},
            "slots": {str(i): [v[i] for v in settings] for i in dirty},
        }

    def _apply_control_blob(self, ctl: dict) -> None:
        """Every rank: mirror rank 0's round into this rank's tuner and
        parameters (followers' Receiver objects are not updated; only the
        parameters matter there)."""
        pipe = self.pipeline
        width = pipe.cfg.num_channels
        if ctl["round"] != self._mh_round + 1 or ctl["width"] != width:
            raise RuntimeError(
                f"front end {self.uuid}: control round {ctl['round']} at "
                f"width {ctl['width']}, expected round {self._mh_round + 1}"
                f" at width {width}: the ranks fell out of lockstep")
        self._mh_round += 1
        if pmesh.world()[0] != 0:
            t = ctl["tuner"]
            if t["centre_frequency"] != self.tuner.centre_frequency:
                self.tuner.set_centre_frequency(int(t["centre_frequency"]))
            if t["offset_ppm"] != self.tuner.offset_ppm:
                self.tuner.set_offset_ppm(int(t["offset_ppm"]))
            if bool(t["agc"]) != self.tuner.agc:
                self.tuner.set_agc(bool(t["agc"]))
            if not self.tuner.agc and t["gain_db"] is not None and (
                    float(t["gain_db"]) != self.tuner.gain_db):
                self.tuner.set_gain_db(float(t["gain_db"]))
        mirror = self._mh_settings
        changed = []
        for key, values in ctl["slots"].items():
            i = int(key)
            if [v[i] for v in mirror] != values:
                for v, x in zip(mirror, values):
                    v[i] = x
                changed.append(i)
        if not changed:
            return
        shared = self._shared_bw
        if shared is not None and all(
                mirror[1][i] == shared[0] and mirror[2][i] == shared[1]
                for i in changed):
            sub = make_channelized_params(
                dataclasses.replace(pipe.cfg, num_channels=len(changed)),
                *([v[i] for i in changed] for v in mirror),
                actual_sample_rate=self.actual_sample_rate, device="cpu")
            pipe.update_params_slots(changed, sub)
        else:
            # a bandwidth left (or rejoined) the shared FIR kernels: the
            # parameters' structure changes, so rebuild from the mirror
            self._note_shared_bw(width, mirror)
            pipe.update_params(self._make_params(width, mirror))

    def _agreed_block(self):
        """This round's block, the same source block on every rank, and its
        index; ``(None, -1)`` where a rank's source ended, on every rank.

        Each rank reads its next block; one all-reduce gives the largest
        and the smallest block index of the group and whether a source
        ended. Where they differ (a ring dropped more blocks on one rank),
        a rank behind reads ahead to the largest, passing over blocks
        (:attr:`skipped_blocks`, drops), and the ranks agree again (a rank
        can overshoot where its ring drops meanwhile). A failed collective
        raises, and the pump stops."""
        block = self.tuner.read_block()
        while True:
            ended = block is None
            index = -1 if ended else self.tuner.block_index
            top, bottom, any_ended = phost.agree_index(index, ended)
            if any_ended:
                return None, -1
            if top == bottom:
                return block, top
            while index < top:
                block = self.tuner.read_block()
                if block is None:
                    break
                self.skipped_blocks += 1
                index = self.tuner.block_index

    def _run_once_multihost(self) -> bool:
        """One lockstep round: the control broadcast and its writes, the
        agreement on the round's source block, this rank's time slice of
        it, the step, and the collective gathers of the spectrum row and
        the subscribed audio rows (HTTP delivery on rank 0). Where any
        rank's source ended, every rank stops at this round."""
        payload = None
        if pmesh.world()[0] == 0:
            payload = json.dumps(self._control_blob()).encode()
        ctl = json.loads(phost.broadcast_blob(payload))
        c0 = trace.now()
        self._apply_control_blob(ctl)
        c1 = trace.now()
        block, index = self._agreed_block()
        if block is None:
            self.running = False
            return False
        self.served.append((self._mh_round, index))
        lo, hi = self._mh_slice
        planes = _to_planes(block)[:, lo:hi]
        # a round's block id is the count of rounds served before it
        bid = self.block_count
        self.trace.begin(bid)
        self.trace.got(bid, trace.now(), 0, 1)
        events = self._step_begin()
        d0 = trace.now()
        out = self.pipeline.process_host(planes)
        d1 = trace.now()
        self.trace.dispatched(bid, c0, c1, d0, d1)
        self._step_end(bid, events, d0, d1)
        self.block_count += 1
        if out is not None:
            self._publish_multihost(out, ctl["rows"], ctl["want_spectrum"])
        return True

    def _publish_multihost(self, out, rows, want_spectrum: bool) -> None:
        audio, latest_db = out
        if want_spectrum:
            # the last rank's row is the block's latest
            spec = phost.gather_to_host(latest_db[None])[-1]
            with self._spec_lock:
                self._spectrum_db = torch.from_numpy(spec)
        rows = [r for r in rows if r < audio.channels]
        if not rows:
            return
        sel = phost.gather_to_host(audio.fetch_rows(rows), dim=-1)
        if pmesh.world()[0] == 0:
            self._deliver_rows(rows, sel)

    def _grow_worker(self) -> None:
        """Build the grown pipeline off the pump thread, then hand it to the
        pump. If capacity grew AGAIN meanwhile, loop and rebuild at the
        latest width; only a pipeline matching the slot table is published.
        One zero block through the new pipeline moves first-call costs (a
        kernel build where the grown width first selects a kernel, pinned
        buffers) off the pump."""
        while True:
            with self._growth_lock:
                target = self.cfg.num_channels
            log.info("front end %s: growing to %d channels", self.uuid,
                     target)
            t0 = time.perf_counter()
            try:
                with self._ctrl_lock:
                    settings = self._slot_settings(target)
                pipe = self._build_pipeline(target, settings)
                # the warm block, and on the card the graphs' capture, on
                # this thread while the pump serves: a capture is
                # thread-local and on a stream of its own (pipeline.graph)
                pipe.process_host_sync(
                    np.zeros((2, self.cfg.block_frames), np.float32))
                pipe.reset()
            except BaseException as e:
                # the wider pipeline is the only one that serves the new
                # slots: the pump stops at its next block (see run_once)
                log.exception("front end %s: growth build failed", self.uuid)
                self._fault = ("growth build", e)
                with self._growth_lock:
                    self._grow_thread = None
                return
            with self._growth_lock:
                if self.cfg.num_channels == target:
                    self._pending_swap = (pipe, settings)
                    self._grow_thread = None
                    log.info("front end %s: %d-channel pipeline ready in "
                             "%.1fs, swapping at the next block", self.uuid,
                             target, time.perf_counter() - t0)
                    return

    def _swap_grown_pipeline(self) -> list:
        """Pump-thread half of growth: publish the old pipeline's in-flight
        block (returns what :meth:`_publish` returns), carry its DSP state
        into the grown one (new slots start from zeros), swap, and apply
        the control writes made since the build's settings were taken."""
        with self._growth_lock:
            pending, self._pending_swap = self._pending_swap, None
        if pending is None:
            return []
        new_pipe, built_from = pending
        old = self.pipeline
        leftover = old.flush()
        # in the OLD pipeline's audio layout
        gathered = ([] if leftover is None
                    else self._publish_block(leftover, self._inflight_id))
        self._inflight_id = None
        width = new_pipe.cfg.num_channels
        # into the grown pipeline's own buffers: its graphs stay valid
        if isinstance(old, ChannelizedPipeline) and isinstance(
                new_pipe, ChannelizedPipeline):
            # in the history domain the grown step carries (the slots
            # added may move it between the per-channel kernel and the
            # time-major tail)
            new_pipe.load_state(grow_channelized_state(
                old.state_for(new_pipe), width))
        elif isinstance(old, FrontEndPipeline) and isinstance(
                new_pipe, FrontEndPipeline):
            new_pipe.load_state(grow_state(old.state, width))
        else:
            # engine flip (direct -> channelized past the auto threshold),
            # or the sharded engine (its mesh may change with the width;
            # the JAX package restarts it too): the carries do not carry
            # over; existing channels see one FIR-length transient
            log.info("front end %s: %s across growth; state restarts fresh",
                     self.uuid, "sharded engine" if self.engine == "sharded"
                     else "engine changed")
        for name, n in self._graph_stats_of(old).items():
            self._retired_graph_stats[name] = (
                self._retired_graph_stats.get(name, 0) + n)
        with self._ctrl_lock:
            self.pipeline = new_pipe
            # control writes made during the build: only the slots whose
            # settings moved since, so that an unchanged slot table keeps
            # the parameters the grown pipeline's graphs were captured on
            self._note_shared_bw(width, built_from)
            now = self._slot_settings(width)
            moved = [i for i in range(width)
                     if any(a[i] != b[i] for a, b in zip(now, built_from))]
            if moved:
                self.rebuild_params(slots=moved)
        return gathered

    @staticmethod
    def _graph_stats_of(pipe) -> dict[str, int]:
        stats = getattr(pipe, "graph_stats", None)
        return stats() if stats is not None else {}

    def plain_tail(self) -> str | None:
        """On the card, why the serving pipeline's tail runs plain where
        no option asks for it (``ChannelizedPipeline.plain_tail``); None
        where the kernels serve, on the CPU and on the direct engine."""
        return getattr(self.pipeline, "plain_tail", None)

    def graph_kernels_per_block(self) -> int:
        """The kernel nodes one served block's graph holds (0 without)."""
        per_block = getattr(self.pipeline, "graph_kernels_per_block", None)
        return per_block() if per_block is not None else 0

    def graph_stats(self) -> dict[str, int]:
        """The CUDA graphs' counts over this front end's pipelines
        (:meth:`.pipeline.frontend.HostPipeline.graph_stats`):
        ``captures``, ``replays``, ``warms`` (eager blocks before a
        capture) and ``kernels`` (the kernel nodes of every replayed graph,
        summed)."""
        now = self._graph_stats_of(self.pipeline)
        return {name: self._retired_graph_stats.get(name, 0) + now.get(name, 0)
                for name in ("captures", "replays", "warms", "kernels")}

    def stop(self) -> None:
        if not self.running:
            return
        self.running = False
        if self._capture:
            self._capture.stop()
        # tuner.stop() unblocks an in-flight read; join the capture thread
        # afterwards so no reader outlives its device handle
        self.tuner.stop()
        if self._capture:
            self._capture.join(timeout=5.0)
            self._capture = None
        self.ring.close()
        if self._fanout_thread is not None:
            self._fanout.close()  # worker drains what's queued, then exits
            self._fanout_thread.join(timeout=2.0)
            self._fanout_thread = None

    # ---- the block pump ---------------------------------------------
    def run_once(self, timeout: float = 1.0) -> bool:
        """Serve the next block and everything the ring holds behind it:
        per block, growth swap -> control writes -> step -> publish, then
        one hand-off of the blocks' gathered audio to the fan-out. Blocks
        until the capture ring has a block (rtlsdrtuner.cxx:265-285). A
        backlog (a stall of the pump) is drained whole here, block after
        block: on the card each is one graph replay, so the catch-up costs
        the host a replay a block (the JAX package scans a fixed number of
        blocks in one dispatch). An error of the step, or of the fan-out
        worker or a growth build since the last block, propagates: nothing
        here carries on past a failed device step.

        Each block's row in the flight recorder gets ``got`` (with the
        ring's depth and the blocks served in this call), ``control``
        (the writes applied before it), ``dispatch`` (``process_host``) and
        later its step's device time; the block whose outputs
        ``process_host`` handed back gets ``publish`` (with the rows
        gathered) and ``handoff`` (with the fan-out queue's depth)."""
        if self._fault is not None:
            (what, fault), self._fault = self._fault, None
            raise RuntimeError(
                f"front end {self.uuid}: {what} failed") from fault
        if self.multihost:
            return self._run_once_multihost()
        block = self.ring.get(timeout)
        if block is None:
            return False
        got = trace.now()
        blocks = [block] + self.ring.drain(self.ring.depth)
        drained = trace.now()
        popped = self.ring.take_ids()
        if len(popped) != len(blocks):  # a stand-in ring's blocks
            popped = [(None, 0)] * len(blocks)
        rec = self.trace
        for k, (bid, depth) in enumerate(popped):
            rec.got(bid, drained if k else got, depth, len(blocks))
        handoff = Handoff()
        for blk, (bid, _) in zip(blocks, popped):
            if self._pending_swap is not None:
                flushed = self._inflight_id
                handoff.add(flushed, self._swap_grown_pipeline())
            c0 = trace.now()
            self.apply_control()
            c1 = trace.now()
            iq_planes = _to_planes(blk)
            events = self._step_begin()
            d0 = trace.now()
            out = self.pipeline.process_host(iq_planes)
            d1 = trace.now()
            rec.dispatched(bid, c0, c1, d0, d1)
            self._step_end(bid, events, d0, d1)
            self.block_count += 1
            out_id, self._inflight_id = self._inflight_id, bid
            if out is not None:  # None: pipeline priming
                handoff.add(out_id, self._publish_block(out, out_id))
        if handoff:
            depth = len(self._fanout._q)
            h0 = trace.now()
            self._fanout.put(handoff)
            h1 = trace.now()
            for bid in handoff.ids:
                rec.handed(bid, h0, h1, depth)
        return True

    def _step_begin(self):
        """Two timing events for the next block's step, the first recorded
        on the pump's stream before its H2D copy; None off the card. Like
        the staging copies' events, they are recorded outside
        ``pipeline.graph.LAUNCH_LOCK``: only a graph launch deadlocked
        against a profiler's stop."""
        if self._step_stream is None:
            dev = getattr(self.pipeline, "device", self.device)
            if dev.type != "cuda":
                return None
            # the device's current stream, where process_host queues its
            # copy and replay (a lookup costs the host microseconds)
            self._step_stream = torch.cuda.current_stream(dev)
        pair = self._free_events.pop() if self._free_events else (
            torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
        pair[0].record(self._step_stream)
        return pair

    def _step_end(self, bid, events, d0: int, d1: int) -> None:
        """After block ``bid``'s ``process_host``: record the second event
        after its replay, and store the device time of every earlier step
        whose events have completed, without a wait. Off the card the step
        ran inside ``process_host``: its host time is its time."""
        if events is None:
            self.trace.step(bid, d1 - d0)
            return
        events[1].record(self._step_stream)
        self._step_events.append((bid, events))
        while self._step_events and self._step_events[0][1][1].query():
            done, (a, b) = self._step_events.popleft()
            self.trace.step(done, int(a.elapsed_time(b) * 1e6))
            self._free_events.append((a, b))

    def _publish_block(self, out, bid) -> list:
        """:meth:`_publish` of block ``bid``'s outputs, stamped."""
        p0 = trace.now()
        pairs = self._publish(out)
        self.trace.published(bid, p0, trace.now(),
                             sum(len(rows) for _, rows in pairs))
        return pairs

    def _publish(self, out) -> list:
        """Hand (audio, spectrum) to HTTP readers, on the pump's stream
        before the next block: the spectrum row is copied, and the rows of
        the receivers with consumers are gathered from the audio (a graph
        replay two blocks on rewrites both). Returns ``[(gathered, rows)]``
        for the fan-out, empty with no consumer (the reference's
        zero-consumer no-op, audiostream.cxx:67-68). A sharded engine's
        rows are copied out of its pieces on their devices."""
        from .web.audiostream import AudioStreamManager

        audio, latest_db = out
        latest_db = latest_db.clone()
        with self._spec_lock:
            self._spectrum_db = latest_db
        # per-block channelized serving audio is time-major [af, C]; the
        # direct engine's is channel-major; the sharded engine's pieces
        # know their own layout
        if isinstance(audio, ShardedAudio):
            tm, width = False, audio.channels
        else:
            tm = audio.ndim == 2 and self.pipeline.audio_time_major
            width = (audio.shape[1] if (tm or audio.ndim == 3)
                     else audio.shape[0])
        rows = tuple(
            i for i, rx in enumerate(self._slots[:width])
            if rx is not None
            and (AudioStreamManager.has_consumers(rx.uuid)
                 or rx.audio_sink is not None))
        if not rows:
            return []
        if isinstance(audio, ShardedAudio):
            return [(audio.select_rows(rows), rows)]
        if self._rows_on_device[:2] != (rows, audio.device):
            self._rows_on_device = (rows, audio.device,
                                    _row_index(rows, audio.device))
        return [(_gather_rows(audio, rows, tm, self._rows_on_device[2]),
                 rows)]

    def _fanout_worker(self) -> None:
        """Audio fan-out off the pump thread (see _publish). Each block of
        a hand-off gets ``picked`` (the queue's get returned), ``fetch``
        (the copy to the host and its wait, with the bytes copied) and
        ``deliver`` (with the encode time, the consumers pushed, those
        whose queue dropped it and the deepest queue after the push)."""
        rec = self.trace
        while True:
            item = self._fanout.get(timeout=0.5)
            if item is None:
                if self._fanout.closed or not self.running:
                    return
                continue
            picked = trace.now()
            ids = getattr(item, "ids", ())
            if len(ids) != len(item):
                ids = [None] * len(item)
            for (gathered, rows), bid in zip(item, ids):
                t0 = trace.now()
                try:
                    sel = _rows_to_host(gathered)
                except BaseException as e:
                    log.exception("front end %s: fan-out fetch failed",
                                  self.uuid)
                    self._fault = ("audio fan-out", e)
                    return
                t1 = trace.now()
                if sel.ndim == 3:  # a backlog's [blocks, k, af]
                    parts = []
                    for b in range(sel.shape[0]):
                        self._deliver_rows(rows, sel[b])
                        parts.append(self._delivery)
                    d0, d1 = parts[0][0], parts[-1][1]
                    counts = [sum(p[j] for p in parts) for j in (2, 3, 4)]
                    delivery = (d0, d1, *counts, max(p[5] for p in parts))
                else:
                    self._deliver_rows(rows, sel)
                    delivery = self._delivery
                rec.delivered(bid, picked, t0, t1, sel.nbytes, *delivery)

    def _deliver_rows(self, rows, sel) -> None:
        """Push fetched audio rows to stream consumers and local sinks;
        leaves its span and the pushes' counters in ``_delivery``."""
        from .web.audiostream import AudioStreamManager

        t0 = trace.now()
        encode_ns = pushed = drops = deepest = 0
        for k, i in enumerate(rows):
            rx = self._slots[i] if i < len(self._slots) else None
            if rx is None:
                continue
            row = sel[k]
            if AudioStreamManager.has_consumers(rx.uuid):
                done = AudioStreamManager.publish(rx.uuid, row,
                                                  self.cfg.audio_rate)
                if done is not None:
                    encode_ns += done[0]
                    pushed += done[1]
                    drops += done[2]
                    if done[3] > deepest:
                        deepest = done[3]
            if rx.audio_sink is not None:
                with rx._sink_lock:
                    sink = rx.audio_sink
                    if sink is None:
                        continue
                    try:
                        sink.write(row)
                        bad = getattr(sink, "failed", False)
                    except Exception:
                        log.exception("receiver %s: audio sink write failed;"
                                      " unbinding", rx.uuid)
                        bad = True
                    if bad:
                        rx.audio_sink = None
                        try:
                            sink.close()
                        except Exception:
                            pass
        self._delivery = (t0, trace.now(), encode_ns, pushed, drops, deepest)

    # ---- readers (HTTP threads) ---------------------------------------
    def get_spectrum_db(self) -> np.ndarray:
        """Latest dB spectrum, ascending frequency (spectrumsink.cxx:125),
        copied from the device on demand: the UI polls at 5 Hz while blocks
        arrive at ~23 Hz. Under multihost the row is gathered by the pump,
        and only for SPECTRUM_WANTED_S after a poll."""
        if self.multihost:
            self._mh_spec_wanted = time.monotonic()
        with self._spec_lock:
            spec = self._spectrum_db
        if spec is None:
            return np.full(self.cfg.fft_size, -10000.0, np.float32)
        return spec.cpu().numpy().copy()

    @property
    def step_samples(self) -> int:
        """Blocks whose step device time has been read."""
        return self.trace.steps

    def profile_ns_per_frame(self) -> float:
        """The step's mean device time per input frame over the last
        ``trace.STATUS_BLOCKS`` blocks whose time was read: the per-frame
        processing cost of dspblock.cxx:93-104 (off the card the step's
        host time in ``process_host``)."""
        rec = self.trace
        steps = rec.column(rec.rows(rec.next_id - trace.STATUS_BLOCKS),
                           "step_ns")
        steps = steps[steps > 0]
        if not steps.size:
            return 0.0
        return float(steps.mean()) / self.cfg.block_frames

    def throughput_factor(self) -> float | None:
        """Processed signal time / wall time since capture started: ~1.0
        while keeping up with a paced source, below when blocks drop."""
        blocks = self.block_count - getattr(self, "_blocks_at_start", 0)
        if not self.running or blocks <= 0:
            return None
        elapsed = time.monotonic() - self.started_monotonic
        if elapsed <= 0:
            return None
        return blocks * self.cfg.block_seconds / elapsed

    def close(self) -> None:
        self.stop()
        for rx in list(self.receivers.values()):
            rx.close()
        Radio.front_ends.pop(self.uuid, None)


class Radio:
    """Global registries (radio.cxx:32-60); the pump is the app's."""

    front_ends: dict[str, FrontEnd] = {}
    receivers: dict[str, Receiver] = {}

    @classmethod
    def profile(cls) -> None:
        for fe in cls.front_ends.values():
            log.info(
                "frontend %s: %.1f ns/frame (%.2fx realtime), %d blocks, "
                "%d dropped",
                fe.uuid,
                fe.profile_ns_per_frame(),
                (1e9 / fe.cfg.sample_rate)
                / max(fe.profile_ns_per_frame(), 1e-9),
                fe.block_count,
                fe.dropped_blocks,
            )

    @classmethod
    def reset(cls) -> None:
        """Tear down everything (tests)."""
        for fe in list(cls.front_ends.values()):
            fe.close()
        for rx in list(cls.receivers.values()):
            rx.close()
        cls.front_ends.clear()
        cls.receivers.clear()
