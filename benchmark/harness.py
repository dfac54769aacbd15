"""One run of one cell: the front end built from the configuration's
topology as the server builds it, fed by the benchmark's own generator,
drained by the pump, listened to, measured, then checked against the plain
reference.

The front end is ``RadioApp.build``'s, with the topology's tuner replaced
by :func:`idle_tuner` (no hardware; its capture thread idles) and the
traffic's receivers spread over its slot table (:meth:`Run.slots`). ``FrontEnd.start`` warms it (the zero block,
the graphs' capture). The pump is ``FrontEnd.run_once`` in a loop on a
thread of its own, with the front end's fan-out thread running as it does
in serving. The generator puts the seed's blocks into the front end's ring
(``BlockRing.put``): on a schedule of its own in an open loop, or, in a
closed one, whenever fewer than ``in_flight`` blocks are offered and not
yet read by every listener. Listeners are in-process
consumers of ``AudioStreamManager.subscribe`` (a stand-in for the
server's HTTP clients), read by a few threads (:class:`Readers`).

Spans and tags come from wrappers the benchmark sets on the front end's
own objects (``pipeline.process_host``, ``_publish``, ``_deliver_rows``,
``ring.get``, ``pipeline.update_params_slots``, each listener's ``push``);
no program file is touched. A block is known by its sequence number from
the generator to the listeners' reads.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import sys
import threading
import time
import zlib

import numpy as np

from . import check, reference, signal

#: how long after the window closes a due answer may still arrive
LATE_S = 60.0
#: blocks served before the window opens (every listener reads them)
WARM_BLOCKS = 8
#: the listeners' stream: 16-bit PCM WAV, as ``check.wav_crc`` reads it
AUDIO_FORMAT = "wav"
#: the most threads that read the listeners (the card's host has 8 cores)
READER_THREADS = 8


class TaggedRows(tuple):
    """The subscribed rows of one published block, with its sequence
    number: the fan-out hands them to ``_deliver_rows`` as they are."""

    def __new__(cls, rows, seq: int):
        obj = super().__new__(cls, rows)
        obj.seq = seq
        return obj


@dataclasses.dataclass
class Block:
    """What a run records of one block."""

    seq: int
    due: float = math.nan  # open loop: when it was due
    put: float = math.nan  # when the generator put it in the ring
    dispatch: tuple = ()  # (start, end) of process_host
    handed: float = math.nan  # when the run_once that published it ended
    delivered: tuple = ()  # (start, end) of _deliver_rows
    reads: int = 0  # listener chunks read
    last_read: float = math.nan


#: the tuner driver the run's topology names: :func:`idle_tuner`
DRIVER = "benchmark"


def watch_drops(queue, lock, counter: str, seqs_of, into: set) -> None:
    """Note in ``into`` the blocks that ``queue.put`` drops as it counts a
    drop (a drop-oldest queue with one producer: the oldest item just
    before a put that raised ``counter`` is the one dropped; a consumer
    that took it first leaves the count as it was)."""
    put = queue.put

    def watched(item):
        with lock:
            oldest = queue._q[0] if queue._q else None
        before = getattr(queue, counter)
        put(item)
        if oldest is not None and getattr(queue, counter) != before:
            into.update(seqs_of(oldest))

    queue.put = watched


def idle_tuner(subdevice: str = ""):
    """Stands in for the configuration's tuner: it starts, and its capture
    thread waits until it stops (the generator fills the ring instead)."""
    from webradio_tpu_torch.io.source import SampleSource
    from webradio_tpu_torch.io.tuner import Tuner

    class Idle(SampleSource):
        def __init__(self):
            super().__init__()
            self.stopped = threading.Event()

        def start(self):
            self.stopped.clear()
            return True

        def stop(self):
            self.stopped.set()

        def read_block(self):
            self.stopped.wait()
            return None

    return Tuner(Idle(), name="benchmark generator")


class Probe:
    """The wrappers on one front end, and what they record."""

    def __init__(self, fe, slot_of: dict):
        self.fe = fe
        self.slot_of = slot_of  # receiver index -> slot
        self.rx_of_slot = {s: i for i, s in slot_of.items()}
        self.blocks: dict[int, Block] = {}
        self._obj: dict[int, tuple] = {}
        self.served: list[int] = []  # seqs in dispatch order
        self.published: list[int] = []
        self.publish_started = -1
        self._inflight = None
        self._out_seq = None
        self._this_call: list[int] = []
        self.applied: dict[int, list] = {}  # seq -> retune numbers
        self._pending_retunes: list[int] = []
        self.retunes_applied = 0
        self.ring_wait_s = 0.0
        self.pump_calls: list = []  # (start, end, ring wait s, blocks,
        #                              process_host s)
        self._call_dispatch_s = 0.0
        self.kept_rows: dict[int, tuple] = {}  # seq -> (slots, rows)
        self.keep: set = set()  # the seqs whose rows are kept: compared
        self.current = -1
        self.space = threading.Condition()
        self.ring_dropped: set = set()
        self.fanout_dropped: set = set()
        pipe = fe.pipeline
        self._orig = {"process_host": pipe.process_host,
                      "publish": fe._publish, "deliver": fe._deliver_rows,
                      "slots": pipe.update_params_slots}
        pipe.process_host = self._process_host
        pipe.update_params_slots = self._update_params_slots
        fe._publish = self._publish
        fe._deliver_rows = self._deliver_rows
        ring = fe.ring
        get, drain = ring.get, ring.drain

        def ring_get(timeout=None):
            t0 = time.perf_counter()
            try:
                return get(timeout)
            finally:
                self.ring_wait_s += time.perf_counter() - t0
                with self.space:
                    self.space.notify_all()

        def ring_drain(max_n):
            out = drain(max_n)
            with self.space:
                self.space.notify_all()
            return out

        ring.get, ring.drain = ring_get, ring_drain
        watch_drops(ring, ring._lock, "dropped_blocks",
                    lambda view: [self._obj.pop(id(view), (-1,))[0]],
                    self.ring_dropped)
        watch_drops(fe._fanout, fe._fanout._cv, "dropped",
                    lambda item: [rows.seq for _, rows in item],
                    self.fanout_dropped)

    def block(self, seq: int) -> Block:
        b = self.blocks.get(seq)
        if b is None:
            b = self.blocks[seq] = Block(seq)
        return b

    # ---- generator side ------------------------------------------------
    def put(self, pool_block: np.ndarray, seq: int) -> None:
        """Put a fresh view of a pool block in the ring, known by ``seq``."""
        view = pool_block.view()
        self._obj[id(view)] = (seq, view)
        self.block(seq).put = time.perf_counter()
        self.fe.ring.put(view)

    # ---- pump side -------------------------------------------------------
    def _process_host(self, planes):
        entry = self._obj.pop(id(planes), None)
        seq = -1 if entry is None else entry[0]
        if self._pending_retunes:
            self.applied[seq] = self._pending_retunes
            self._pending_retunes = []
        self._out_seq, self._inflight = self._inflight, seq
        t0 = time.perf_counter()
        out = self._orig["process_host"](planes)
        t1 = time.perf_counter()
        self._call_dispatch_s += t1 - t0
        self.block(seq).dispatch = (t0, t1)
        self.served.append(seq)
        return out

    def _update_params_slots(self, idx, sub, *args, **kw):
        self._pending_retunes.append(self.retunes_applied)
        self.retunes_applied += 1
        return self._orig["slots"](idx, sub, *args, **kw)

    def _publish(self, out):
        seq = self._out_seq
        self.publish_started = seq
        gathered = self._orig["publish"](out)
        self.published.append(seq)
        self._this_call.append(seq)
        return [(g, TaggedRows(rows, seq)) for g, rows in gathered]

    def run_once(self, timeout: float) -> bool:
        """One ``FrontEnd.run_once``, timed: its span, its ring wait, its
        blocks' dispatch time, and when it handed blocks on."""
        self.ring_wait_s = 0.0
        self._call_dispatch_s = 0.0
        self._this_call = []
        n0 = len(self.served)
        t0 = time.perf_counter()
        got = self.fe.run_once(timeout=timeout)
        t1 = time.perf_counter()
        for seq in self._this_call:
            self.block(seq).handed = t1
        if got:
            self.pump_calls.append((t0, t1, self.ring_wait_s,
                                    len(self.served) - n0,
                                    self._call_dispatch_s))
        return got

    # ---- fan-out side ----------------------------------------------------
    def _deliver_rows(self, rows, sel):
        seq = getattr(rows, "seq", -1)
        self.current = seq
        t0 = time.perf_counter()
        self._orig["deliver"](rows, sel)
        t1 = time.perf_counter()
        self.block(seq).delivered = (t0, t1)
        if seq in self.keep:
            self.kept_rows[seq] = (tuple(rows),
                                   np.array(sel, np.float32, copy=True))
        for old in [s for s in self.kept_rows if s not in self.keep]:
            del self.kept_rows[old]


class Listener:
    """One in-process audio consumer; records each chunk read from it by
    block (sequence number, time, CRC-32 of the bytes)."""

    def __init__(self, probe: Probe, consumer, index: int):
        self.probe, self.consumer, self.index = probe, consumer, index
        self.fifo: collections.deque = collections.deque()
        self.reads: list = []
        self.last_seq = -1
        self.dropped: set = set()  # blocks the consumer's queue dropped
        push = consumer.push

        def tagged_push(data):
            self.fifo.append(probe.current)
            before = consumer.dropped
            push(data)
            if consumer.dropped != before:
                self.dropped.add(self.fifo.pop())

        consumer.push = tagged_push

    def take(self, timeout: float) -> bool:
        """Read one chunk, if one comes within ``timeout``."""
        chunk = self.consumer.read(timeout=timeout)
        if chunk is None:
            return False
        t = time.perf_counter()
        seq = self.fifo.popleft() if self.fifo else -1
        self.reads.append((seq, t, zlib.crc32(chunk)))
        self.last_seq = max(self.last_seq, seq)
        return True


class Readers:
    """The threads that read the listeners: at most :data:`READER_THREADS`,
    each reading its share of the consumers in turn, in the order the
    fan-out pushes to them. The load comes from one process with few
    threads, so the host's scheduling of many reader threads does not
    spread the runs (on an H100 machine's 8-core host, 64 listeners with
    a thread each read ``block_p95_ms`` 75-98 ms across runs of one
    seed)."""

    def __init__(self, probe: Probe, listeners: list, wake: bool):
        self.probe, self.wake = probe, wake
        self.stop = threading.Event()
        n = min(READER_THREADS, len(listeners))
        self.threads = [
            threading.Thread(target=self._run, args=(listeners[i::n],),
                             daemon=True, name=f"listeners-{i}")
            for i in range(n)]

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def join(self) -> None:
        self.stop.set()
        for t in self.threads:
            t.join()

    def _run(self, group: list) -> None:
        for lis in group:
            lis.consumer.read(timeout=LATE_S)  # the stream's header
        while not self.stop.is_set():
            for lis in group:
                # a closed loop's generator waits on the listeners
                if lis.take(0.05) and self.wake:
                    with self.probe.space:
                        self.probe.space.notify_all()


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


class Run:
    """One run of a cell; :meth:`go` returns the result line's fields."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_start: float | None = None,
                 fault=None):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device = bool(trace), device
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.fault = fault
        self.traffic = cell.traffic
        self.chain = reference.Chain(cell.tuner)
        self.period = self.chain.block_seconds

    @staticmethod
    def note(msg: str) -> None:
        print(f"benchmark: {msg}", file=sys.stderr, flush=True)

    # ---- set-up -------------------------------------------------------
    def _topology(self) -> dict:
        """The configuration's topology with the benchmark's tuner and no
        receivers (they are placed after the build)."""
        topo = json.loads(json.dumps(self.cell.config["topology"]))
        topo.pop("server", None)
        topo["tuners"][0]["driver"] = DRIVER
        self.template = topo.pop("receivers")[0]
        topo["receivers"] = []
        return topo

    def slots(self, n: int, capacity: int) -> list:
        """Where the ``n`` receivers sit in the slot table: spread over
        all of it, one in each of ``n`` equal stretches at a seeded place,
        as a long-running server's attaches and detaches leave them (so
        every part of the batch, and every card of a sharded front end,
        holds listened receivers)."""
        rng = np.random.default_rng(self.seed ^ 0x51075)
        stride = capacity // n
        return [i * stride + int(rng.integers(stride)) for i in range(n)]

    def _attach(self, fe) -> list:
        """The plan's receivers, set as ``RadioApp.build`` sets them and
        placed at :meth:`slots`; then one parameter build at full width."""
        from webradio_tpu_torch.radio import Receiver

        tpl = self.template
        rxs = []
        slots = self.slots(len(self.plan.receivers), len(fe._slots))
        for r, slot in zip(self.plan.receivers, slots):
            rx = Receiver()
            rx.update(if_frequency=r.if_hz,
                      if_bandwidth=tpl.get("if_bandwidth", 80_000),
                      af_bandwidth=tpl.get("af_bandwidth", 8_000),
                      demodulator=tpl.get("demodulator", "AM"),
                      af_gain=r.gain_db,
                      squelch_threshold=tpl.get("squelch_threshold"))
            rx.front_end = fe
            fe._slots[slot] = rx
            rxs.append(rx)
        fe.rebuild_params()
        return rxs

    def setup(self) -> None:
        import torch

        from webradio_tpu_torch.app import RadioApp
        from webradio_tpu_torch.io.tuner import TUNER_DRIVERS
        from webradio_tpu_torch.web.audiostream import AudioStreamManager

        tr = self.traffic
        marks = self.setup_marks = [("begin", time.perf_counter())]
        self.retune_times = [
            (i + 0.5) / tr["retunes_per_s"]
            for i in range(int(tr["retunes_per_s"] * self.seconds))]
        self.plan = signal.make_plan(self.cell.tuner, tr, self.seed,
                                     len(self.retune_times))
        self.pool = signal.make_pool(self.cell.tuner, self.plan, self.seed,
                                     self.device)
        marks.append(("input", time.perf_counter()))
        TUNER_DRIVERS.setdefault(DRIVER, idle_tuner)
        self.app = RadioApp(self._topology(), device=self.device)
        self.app.build()
        self.fe = fe = self.app.front_ends[0]
        self.receivers = self._attach(fe)
        marks.append(("parameters", time.perf_counter()))
        if not fe.start():
            raise RuntimeError("the front end did not start")
        marks.append(("warm block and capture", time.perf_counter()))
        slot_of = {i: fe.slots_of(rx)[0]
                   for i, rx in enumerate(self.receivers)}
        self.probe = Probe(fe, slot_of)
        if self.fault is not None:
            self.fault(self)
        rate = fe.cfg.audio_rate
        self.listeners = [
            Listener(self.probe, AudioStreamManager.subscribe(
                rx.uuid, AUDIO_FORMAT, rate), i)
            for i, rx in enumerate(self.receivers)]
        self.readers = Readers(self.probe, self.listeners,
                               wake=tr["loop"] == "closed")
        self.readers.start()
        if self.trace:
            from . import profile

            profile.warm()
            marks.append(("profiler", time.perf_counter()))
        self.devices = self._devices()
        if self.cuda:
            for d in self.devices:
                torch.cuda.reset_peak_memory_stats(d)

    @property
    def cuda(self) -> bool:
        return self.device != "cpu"

    def _devices(self) -> list:
        mesh = getattr(self.fe.pipeline, "mesh", None)
        if mesh is not None:
            return sorted({str(mesh.devices[p]) for p in
                           mesh.local_positions})
        return [str(self.fe.pipeline.device)]

    # ---- the threads ------------------------------------------------------
    def _pump(self) -> None:
        try:
            while not self._stop_pump.is_set():
                self.probe.run_once(timeout=0.05)
        except BaseException as e:  # the run fails with it
            self.pump_error = e

    def _generate(self) -> None:
        """Put blocks: open loop on a schedule from ``t0``; closed loop
        keeping at most ``in_flight`` blocks offered and not yet read by
        every listener. Stops at ``_stop_gen``."""
        probe, tr = self.probe, self.traffic
        pool = self.pool
        seq = 0
        if tr["loop"] == "open":
            while not self._stop_gen.is_set():
                due = self.t0 + seq * self.period
                delay = due - time.perf_counter()
                if delay > 0:
                    self._stop_gen.wait(delay)
                    if self._stop_gen.is_set():
                        break
                probe.block(seq).due = due
                self._offer(seq)
                probe.put(pool[seq % len(pool)], seq)
                seq += 1
            return
        # closed on delivery: at most ``in_flight`` blocks between the
        # generator and the last listener
        window = int(tr["in_flight"])
        while not self._stop_gen.is_set():
            with probe.space:
                while (seq - 1 - min(lis.last_seq for lis in self.listeners)
                       >= window and not self._stop_gen.is_set()):
                    probe.space.wait(0.05)
            if self._stop_gen.is_set():
                break
            self._offer(seq)
            probe.put(pool[seq % len(pool)], seq)
            seq += 1

    def _offer(self, seq: int) -> None:
        """Note an offered block: in the window or not, and into the seeded
        sample of blocks compared."""
        t = time.perf_counter()
        if self.t_w0 is not None and self.t_w0 <= (
                self.probe.block(seq).due if self.traffic["loop"] == "open"
                else t) < self.t_w1:
            self.offered.append(seq)
            self.sample.offer(seq)
            # however long the run takes to close after the window, the
            # window's latest blocks stay compared
            self.probe.keep = set(check.compared(self.sample.sample,
                                                 self.offered))

    def _poll(self) -> None:
        rate = self.traffic["spectrum_polls_per_s"]
        if not rate:
            return
        probe = self.probe
        while not self._stop_side.wait(1.0 / rate):
            a = probe.publish_started
            row = self.fe.get_spectrum_db()
            b = probe.publish_started
            t = time.perf_counter()
            self.polls.append((t, a, b, np.array(row, np.float64)))

    def _retune(self) -> None:
        for i, (t_rel, (rx, if_hz)) in enumerate(zip(self.retune_times,
                                                      self.plan.retunes)):
            if self._stop_side.wait(max(0.0, self.t_w0 + t_rel
                                        - time.perf_counter())):
                return
            self.receivers[rx].update(if_frequency=if_hz)
            self.retunes_made += 1

    # ---- the run -----------------------------------------------------------
    def go(self) -> dict:
        import torch

        tr = self.traffic
        self.offered, self.polls = [], []
        self.sample = check.Reservoir(self.seed)
        self.retunes_made = 0
        self.pump_error = None
        self.t_w0 = self.t_w1 = None
        self._stop_pump, self._stop_gen = threading.Event(), threading.Event()
        self._stop_side = threading.Event()
        threads = [threading.Thread(target=self._pump, daemon=True,
                                    name="bench-pump")]
        warm = WARM_BLOCKS
        self.t0 = time.perf_counter() + 0.05
        if tr["loop"] == "open":
            # the window opens at the due time of the first block past the
            # warm-up
            self.t_w0 = self.t0 + warm * self.period
            self.t_w1 = self.t_w0 + self.seconds
        gen = threading.Thread(target=self._generate, daemon=True,
                               name="bench-generator")
        threads[0].start()
        gen.start()
        self._await(lambda: self._delivered_all(range(warm)), LATE_S,
                    "the warm-up blocks")
        if tr["loop"] == "closed":
            self.t_w0 = time.perf_counter()
            self.t_w1 = self.t_w0 + self.seconds
        else:
            while time.perf_counter() < self.t_w0:
                time.sleep(0.001)
        self.setup_marks.append(("warm-up blocks", self.t_w0))
        prev = self.t_start
        parts = []
        for name, t in [("imports and the card", self.setup_marks[0][1])] \
                + self.setup_marks[1:]:
            parts.append(f"{name} {t - prev:.3f} s")
            prev = t
        self.note("set-up: " + ", ".join(parts))
        side = [threading.Thread(target=self._poll, daemon=True,
                                 name="bench-spectrum"),
                threading.Thread(target=self._retune, daemon=True,
                                 name="bench-retune")]
        for t in side:
            t.start()
        window = None
        if self.trace:
            from . import profile

            window = profile.Window()
            window.start()
        setup_s = self.t_w0 - self.t_start
        self.counts = [self._counts()]
        while time.perf_counter() < self.t_w1 and self.pump_error is None:
            time.sleep(0.01)
        self.counts.append(self._counts())
        if window is not None:
            window.stop()
        self._stop_side.set()
        for t in side:
            t.join()
        # the generator goes on: a block is handed on when the next one is
        # dispatched
        self._await(lambda: self._delivered_all(self.offered), LATE_S,
                    "the window's blocks")
        self.t_end_wait = time.perf_counter()
        self._stop_gen.set()
        gen.join()
        time.sleep(0.05)
        self._stop_pump.set()
        threads[0].join()
        self.readers.join()
        if self.pump_error is not None:
            raise RuntimeError("the pump failed") from self.pump_error
        # reserved, not allocated: the graphs' private pools (the captured
        # step's intermediates) are reserved once and replays allocate
        # nothing
        peak = max((torch.cuda.max_memory_reserved(d) for d in self.devices),
                   default=0) if self.cuda else 0
        self._merge_reads()
        timeline = window.timeline() if window is not None else None
        self._release()
        return {"setup_s": setup_s, "memory_peak_bytes": peak,
                "timeline": timeline}

    def _counts(self) -> dict:
        """The program's own counts: its graphs' captures and replays, the
        kernel wrappers' launches, the ring's and fan-out's drops."""
        from webradio_tpu_torch.ops import tail, tail_tm

        fe = self.fe
        out = {"graph_" + k: v for k, v in fe.graph_stats().items()}
        for w in (tail_tm.fused_tail_audio_tm, tail_tm.fused_tail_tm,
                  tail_tm.fused_pfb_tail_audio_tm, tail.fused_receiver_tail):
            out["launches_" + w.__name__] = w.launches
        out["ring_dropped"] = fe.ring.dropped_blocks
        out["fanout_dropped"] = fe.fanout_dropped
        out["dispatched"] = len(self.probe.served)
        return out

    def gates(self) -> dict:
        """What the window did besides its answers: the program's counts
        over it (printed), and on the card the one gate of the timed path,
        that no graph was captured inside the window."""
        a, b = self.counts
        delta = {k: b[k] - a[k] for k in a}
        consumer = sum(lis.consumer.dropped for lis in self.listeners)
        lines = [json.dumps({"window_counts": delta,
                             "consumer_dropped": consumer,
                             "retunes": [self.retunes_made,
                                         self.probe.retunes_applied],
                             "spectrum_polls": len(self.polls),
                             "devices": self.devices})]
        if not self.cuda:
            return {"lines": lines, "numbers": {}, "limits": {}}
        return {"lines": lines,
                "numbers": {"window_captures": delta["graph_captures"]},
                "limits": {"window_captures": 0}}

    def device_info(self, got: dict) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
        import torch

        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": len(self.devices),
                "memory_peak_bytes": int(got["memory_peak_bytes"])}

    def _await(self, cond, limit: float, what: str) -> None:
        t_end = time.perf_counter() + limit
        while not cond():
            if self.pump_error is not None:
                raise RuntimeError("the pump failed") from self.pump_error
            if time.perf_counter() > t_end:
                self.note(f"{what}: not all delivered within {limit:.0f} s")
                return
            time.sleep(0.005)

    def _delivered_all(self, seqs) -> bool:
        """Every listener has read past the last of ``seqs`` (a listener
        reads in order; a block the ring dropped never comes)."""
        last = max(seqs, default=-1)
        return all(lis.last_seq >= last for lis in self.listeners)

    def _merge_reads(self) -> None:
        blocks = self.probe.blocks
        self.crc = {}
        for lis in self.listeners:
            for seq, t, crc in lis.reads:
                b = blocks.get(seq)
                if b is None:
                    continue
                b.reads += 1
                if not b.last_read >= t:
                    b.last_read = t
                self.crc[(seq, lis.index)] = crc

    def _release(self) -> None:
        """Stop and drop the program's state before the reference runs."""
        import torch

        from webradio_tpu_torch.radio import Radio
        from webradio_tpu_torch.web.audiostream import AudioStreamManager

        self.app.close()
        AudioStreamManager.reset()
        Radio.reset()
        self.fe = self.app = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    # ---- after the window ----------------------------------------------------
    def end_to_end(self, setup_s: float) -> dict:
        """Every end-to-end number this run gives, with its counts."""
        blocks = self.probe.blocks
        n = len(self.listeners)
        window = [blocks[s] for s in self.offered]
        done = [b for b in window if b.reads >= n]
        out = {"setup_s": setup_s, "attempted": len(window),
               "failed": len(window) - len(done)}
        if self.traffic["loop"] == "open":
            lat = [(b.last_read if b.reads >= n else self.t_end_wait) - b.due
                   for b in window]
            out["block_p95_ms"] = 1e3 * percentile(lat, 95)
            out["block_p50_ms"] = 1e3 * percentile(lat, 50)
            late = [b.put - b.due for b in window]
            out["generator_late_p95_ms"] = 1e3 * percentile(late, 95)
            out["generator_late_max_ms"] = 1e3 * max(late)
        else:
            inside = [b for b in blocks.values() if b.reads >= n
                      and self.t_w0 <= b.last_read < self.t_w1]
            out["rt_factor"] = len(inside) * self.period / self.seconds
            out["blocks_in_window"] = len(inside)
            done_at = sorted(b.last_read for b in inside)
            out["longest_gap_ms"] = 1e3 * max(
                (y - x for x, y in zip(done_at, done_at[1:])), default=0.0)
        return out

    def record(self) -> check.Record:
        published = self.probe.published
        polls = []
        for _, a, b, row in self.polls:
            cands = [s for s in published if a - 2 <= s <= b] or [b]
            polls.append((cands, row))
        return check.Record(
            chain=self.chain, pool=self.pool, plan=self.plan,
            template=self.template, served=list(self.probe.served),
            applied=dict(self.probe.applied),
            compared=check.compared(self.sample.sample, self.offered),
            polls=polls, listeners=len(self.listeners),
            kept=dict(self.probe.kept_rows), rx_of_slot=self.probe.rx_of_slot,
            crc=self.crc, ring_dropped=set(self.probe.ring_dropped),
            fanout_dropped=set(self.probe.fanout_dropped),
            consumer_dropped={(s, lis.index) for lis in self.listeners
                              for s in lis.dropped})
