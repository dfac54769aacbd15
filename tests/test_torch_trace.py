"""The port's per-block flight recorder (``webradio_tpu_torch.trace``) on
the CPU: one block id from the ring's ``put`` to the fan-out's delivery,
with the stamps in the order the work happens; drops of the ring and of
the fan-out's queue; a drained backlog; a growth swap; a table that wraps;
no thread started per block; the six per-layer metric readers of the
benchmark on a recorder and a device timeline made by hand; the host's
tracks on a ``/profile`` trace; and the benchmark's own wrappers around
the program's calls, which see every call with the recorder in place.

Every front end here runs the direct engine on short blocks on the CPU.
"""

import json
import pathlib
import threading
import time
import types

import numpy as np
import pytest

from webradio_tpu_torch import radio, trace
from webradio_tpu_torch.io.source import SampleSource
from webradio_tpu_torch.io.tuner import Tuner
from webradio_tpu_torch.web.audiostream import AudioStreamManager

REPO = pathlib.Path(__file__).resolve().parents[1]
FS, CR, AR, BF = 1_024_000, 128_000, 32_000, 16_384
CHAIN = dict(sample_rate=FS, channel_rate=CR, audio_rate=AR, block_frames=BF)


class IdleSource(SampleSource):
    """A source whose capture thread waits until it stops: the test puts
    the blocks into the ring itself."""

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


@pytest.fixture
def clean():
    trace.clear()
    yield
    radio.Radio.reset()
    AudioStreamManager.reset()
    trace.clear()


def front_end(capacity=2, listened=1):
    """A direct-engine front end on the CPU with ``listened`` receivers,
    each with a WAV consumer; not started."""
    fe = radio.FrontEnd(Tuner(IdleSource()), radio.ChainConfig(**CHAIN),
                        capacity=capacity, engine="direct", device="cpu")
    consumers = []
    for i in range(listened):
        rx = radio.Receiver()
        rx.update(if_frequency=10_000 * i)
        rx.set_front_end(fe)
        consumers.append(AudioStreamManager.subscribe(rx.uuid, "wav", AR))
    fe.apply_control()
    return fe, consumers


def block(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, BF)).astype(np.float32) * 0.1


def fanout(fe):
    """The front end's fan-out worker on a thread, as ``start`` runs it;
    returns a function that drains it and joins the thread."""
    fe.running = True
    t = threading.Thread(target=fe._fanout_worker, daemon=True)
    t.start()

    def join():
        fe._fanout.close()
        t.join(timeout=10)
        assert not t.is_alive()
        fe.running = False

    return join


def row(fe, bid):
    rows = fe.trace.rows(bid, bid + 1)
    assert len(rows) == 1, f"block {bid} is not held"
    return {name: int(v) for name, v in zip(trace.FIELDS, rows[0])}


def test_one_id_from_put_to_deliver(clean):
    fe, (consumer,) = front_end()
    join = fanout(fe)
    try:
        for k in range(3):
            fe.ring.put(block(k))
            assert fe.run_once(timeout=1.0)
    finally:
        join()
    b0, b1 = row(fe, 0), row(fe, 1)
    assert b0["id"] == 1 and b1["id"] == 2
    order = ["put", "got", "control0", "control1", "dispatch0", "dispatch1"]
    assert all(b0[a] <= b0[b] for a, b in zip(order, order[1:]))
    assert all(b0[f] > 0 for f in order)
    # block 0's outputs come back at the next call: its publish follows
    # block 1's dispatch, then its hand-off, the fan-out's pick, the
    # fetch and the delivery
    after = ["publish0", "publish1", "handoff0", "picked", "fetch0",
             "fetch1", "deliver0", "deliver1"]
    assert b1["dispatch1"] <= b0["publish0"]
    assert all(b0[a] <= b0[b] for a, b in zip(after, after[1:]))
    assert b0["handoff0"] <= b0["handoff1"]
    assert b0["rows"] == 1 and b0["pushed"] == 1 and b0["d2h_bytes"] > 0
    assert b0["consumer_drops"] == 0 and b0["deepest"] >= 1
    assert b0["encode_ns"] > 0 and b0["drained"] == 1
    # the step's time on the CPU is its host time in process_host
    assert b0["step_ns"] == b0["dispatch1"] - b0["dispatch0"]
    assert fe.step_samples == 3
    assert consumer.read(timeout=1) is not None  # the header
    assert consumer.read(timeout=1) is not None  # block 0's audio


def test_a_ring_drop_keeps_put_without_got_and_a_backlog_stamps_each(clean):
    fe, _ = front_end()
    depth = fe.ring.depth
    for k in range(depth + 2):  # two more than the ring holds
        fe.ring.put(block(k))
    assert fe.ring.dropped_blocks == 2
    join = fanout(fe)
    try:
        assert fe.run_once(timeout=1.0)  # the whole backlog
    finally:
        join()
    for bid in (0, 1):
        r = row(fe, bid)
        assert r["put"] > 0 and r["got"] == 0 and r["dispatch0"] == 0
    served = [row(fe, bid) for bid in range(2, depth + 2)]
    assert [r["drained"] for r in served] == [depth] * depth
    assert [r["got_depth"] for r in served] == list(range(depth - 1, -1, -1))
    assert all(r["dispatch1"] > 0 for r in served)
    # each block but the last (still in flight) was published, handed on
    # in the one hand-off, fetched and delivered on its own
    handed = served[:-1]
    assert len({r["handoff0"] for r in handed}) == 1
    assert all(r["deliver1"] > r["fetch0"] > 0 for r in handed)
    assert served[-1]["publish0"] == 0


def test_a_fanout_drop_keeps_handoff_without_picked(clean):
    fe, _ = front_end()
    n = radio.FANOUT_QUEUE_DEPTH + 3
    for k in range(n):  # no fan-out worker yet: its queue drops oldest
        fe.ring.put(block(k))
        assert fe.run_once(timeout=1.0)
    dropped = fe.fanout_dropped
    assert dropped == n - 1 - radio.FANOUT_QUEUE_DEPTH
    join = fanout(fe)
    deadline = time.monotonic() + 10
    while (time.monotonic() < deadline
           and not row(fe, n - 2)["deliver1"]):
        time.sleep(0.01)
    join()
    for bid in range(n - 1):
        r = row(fe, bid)
        assert r["handoff1"] > 0
        if bid < dropped:
            assert r["picked"] == 0 and r["fetch0"] == 0
        else:
            assert r["picked"] >= r["handoff0"] and r["deliver1"] > 0


def test_a_growth_swap_keeps_the_ids(clean):
    fe, _ = front_end(capacity=2, listened=2)
    fe.running = True  # serving as far as growth can tell
    try:
        fe.ring.put(block(0))
        assert fe.run_once(timeout=1.0)
        rx = radio.Receiver()
        rx.set_front_end(fe)  # past capacity: the build runs on a thread
        deadline = time.monotonic() + 60
        while fe._pending_swap is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fe._pending_swap is not None
        old = fe.pipeline
        fe.ring.put(block(1))
        assert fe.run_once(timeout=1.0)  # the swap, then block 1
        assert fe.pipeline is not old and len(fe._slots) == 4
        fe.ring.put(block(2))
        assert fe.run_once(timeout=1.0)
    finally:
        fe.running = False
    b0, b1 = row(fe, 0), row(fe, 1)
    # block 0 was in flight in the old pipeline: the swap published it
    # before block 1's control writes and dispatch
    assert 0 < b0["publish0"] <= b0["publish1"] <= b1["control0"]
    assert b0["rows"] == 2 and b0["handoff0"] > 0
    # block 1 primed the new pipeline and came back at block 2's call
    assert b1["publish0"] >= row(fe, 2)["dispatch1"] > 0
    assert fe._fanout._q[-1].ids == [1]
    assert fe._fanout._q[0].ids == [0]


def test_the_pump_starts_no_thread_a_block(clean, monkeypatch):
    fe, _ = front_end()
    join = fanout(fe)
    started = []
    start = threading.Thread.start

    def counting(self):
        started.append(self.name)
        start(self)

    monkeypatch.setattr(threading.Thread, "start", counting)
    try:
        for k in range(40):
            fe.ring.put(block(k))
            assert fe.run_once(timeout=1.0)
    finally:
        monkeypatch.undo()
        join()
    assert started == []
    assert fe.step_samples == 40


def synthetic(key="synthetic", blocks=trace.TRACE_BLOCKS, n=10,
              period_ns=10_000_000, t0_ns=1_000_000_000):
    """A recorder of ``n`` blocks a ``period_ns`` apart from ``t0_ns``,
    each block's spans of known lengths (ms): control 0.1, dispatch 1,
    publish 2 (at the next block's call), handoff 0.05, fetch 3 + k/10,
    deliver 4 + k/10."""
    rec = trace.Recorder(key, blocks)
    trace._recorders[key] = rec
    ms = 1_000_000
    for k in range(n):
        t = t0_ns + k * period_ns
        rec.begin(k, t, 1)
        rec.got(k, t + ms // 100, 0, 1)
        rec.dispatched(k, t + ms // 10, t + 2 * ms // 10, t + 3 * ms // 10,
                       t + 13 * ms // 10)
        p = t + period_ns + 2 * ms  # the next call
        rec.published(k, p, p + 2 * ms, 1)
        rec.handed(k, p + 2 * ms, p + 2 * ms + ms // 20, 0)
        f0 = p + 3 * ms  # the fetch, then the delivery from its end
        f1 = f0 + 3 * ms + k * ms // 10
        rec.delivered(k, f0, f0, f1, 2048, f1, f1 + 4 * ms + k * ms // 10,
                      1000, 1, 0, 1)
    return rec


def reader(name):
    from benchmark import registry

    return registry.load_reader(REPO / "benchmark" / "metrics"
                                / f"{name}.py")


def view(window, timeline=None):
    return types.SimpleNamespace(window=window, timeline=timeline)


LIVE = {
    # name -> expected value over blocks 2..7 (window [1.02, 1.08) s)
    "publish_ms.live": 2.0,
    "control_ms.live": 0.1,
    "hold_ms.live": float(np.percentile(
        [(10 + 2 + 2.05) - 1.3] * 6, 95)),
    "fetch_ms.live": float(np.percentile([3 + k / 10 for k in range(1, 7)],
                                         95)),
    "deliver_ms.live": float(np.percentile([4 + k / 10 for k in range(1, 7)],
                                           95)),
}


@pytest.mark.parametrize("name", sorted(LIVE))
def test_each_live_reader_on_a_synthetic_recorder(clean, name):
    synthetic()
    # the blocks whose stamps lie in the window: for the pump's own
    # stamps blocks 2..7; a block's publish, fetch and delivery come a
    # period later, blocks 1..6
    got = reader(name).read(view((1.02, 1.08)))
    assert got == pytest.approx(LIVE[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(LIVE) + ["idle_host_share.bulk"])
def test_each_reader_returns_none_where_the_table_wrapped(clean, name):
    from benchmark.profile import Timeline

    synthetic(blocks=8, n=20)  # ids 0..11 are gone
    tl = Timeline([(1.0, 1.2, 0, "k")], 1.0, 1.2)
    assert reader(name).read(view((1.0, 1.2), tl)) is None
    # a window after the oldest held block reads
    late = view((1.16, 1.19), Timeline([(1.16, 1.17, 0, "k")], 1.16, 1.19))
    assert reader(name).read(late) is not None


@pytest.mark.parametrize("name", sorted(LIVE) + ["idle_host_share.bulk"])
def test_each_reader_returns_none_without_rows(clean, name):
    from benchmark.profile import Timeline

    tl = Timeline([(1.0, 1.2, 0, "k")], 1.0, 1.2)
    assert reader(name).read(view((1.0, 1.2), tl)) is None


def test_idle_host_share_on_a_synthetic_timeline(clean):
    from benchmark.profile import Timeline

    synthetic(n=10)
    # the card busy [1.000, 1.005) and [1.030, 1.050) of a window
    # [1.000, 1.060): idle [1.005, 1.030) and [1.050, 1.060), 35 ms
    tl = Timeline([(1.000, 1.005, 0, "a"), (1.030, 1.050, 0, "b")],
                  1.000, 1.060)
    ms = 1e-3
    host = []
    for k in range(10):
        t = 1.0 + k * 0.010
        host += [(t + 0.1 * ms, t + 0.2 * ms), (t + 0.3 * ms, t + 1.3 * ms)]
        p = t + 0.010 + 2 * ms
        host += [(p, p + 2 * ms), (p + 2 * ms, p + 2.05 * ms)]
    idle = [(1.005, 1.030), (1.050, 1.060)]
    inside = sum(max(0.0, min(b, d) - max(a, c))
                 for a, b in idle for c, d in host)
    want = 100 * inside / 0.035
    got = reader("idle_host_share.bulk").read(view((1.0, 1.06), tl))
    assert got == pytest.approx(want, rel=1e-6)
    assert 0 < got < 100


def test_recorder_summary_and_status_fields(clean):
    rec = synthetic(n=10)
    s = rec.summary()
    assert s["blocks"] == 10
    assert s["control_ms"] == {"p50": 0.1, "p95": 0.1}
    assert s["publish_ms"]["p50"] == 2.0
    assert s["hold_ms"]["p50"] == pytest.approx(12.75)
    assert s["step_ms"] is None and s["rows"] == 1.0
    fe, _ = front_end()
    for k in range(3):
        fe.ring.put(block(k))
        assert fe.run_once(timeout=1.0)
    st = fe.trace.summary()
    assert st["blocks"] == 3 and st["dispatch_ms"]["p95"] > 0
    assert st["step_ms"]["p50"] > 0 and st["rows"] == 1
    assert fe.profile_ns_per_frame() > 0


def test_host_tracks_on_a_profile_trace(clean, tmp_path):
    """The recorder's spans in a Chrome trace's own time base: its
    ``baseTimeNanoseconds`` and the profiler's wall clock."""
    from webradio_tpu_torch.web import handlers

    now = time.perf_counter_ns()
    rec = synthetic(n=3, t0_ns=now)
    base = (time.time_ns() // 10**9 - 100) * 10**9
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": base,
                                "traceEvents": [{"ph": "X", "ts": 1.0}]}))
    added = handlers.add_host_tracks(path, now, now + 10**9)
    doc = json.loads(path.read_text())
    host = [e for e in doc["traceEvents"]
            if e.get("pid") == trace.HOST_PID and e["ph"] != "M"]
    assert added == len(host) + 3  # and the three tracks' names
    names = {(e["name"], e["tid"]) for e in host}
    assert {("dispatch", 1), ("fetch", 2), ("put", 3)} <= names
    d0 = next(e for e in host if e["name"] == "dispatch"
              and e["args"]["block"] == 0)
    wall_us = (rec.table[0, trace.COLUMN["dispatch0"]]
               + time.time_ns() - time.perf_counter_ns() - base) / 1e3
    assert abs(d0["ts"] - wall_us) < 5e4  # the two clocks read 50 ms apart
    assert d0["dur"] == pytest.approx(1000.0)


def test_the_benchmarks_wrappers_see_every_call(clean, tmp_path,
                                                monkeypatch):
    """A stand-in cell of 16 slots served through the benchmark's harness
    on the CPU: its wrappers around ``process_host``, ``_publish``,
    ``_deliver_rows``, the ring and the fan-out see every block the
    recorder stamps, by the same numbers; the program's dispatch holds the
    harness's span of ``process_host`` and its delivery lies inside the
    harness's span of ``_deliver_rows``."""
    from benchmark import check, harness, registry, signal
    from webradio_tpu_torch.io.tuner import TUNER_DRIVERS

    # the harness registers its tuner driver: take it out again after
    monkeypatch.setitem(TUNER_DRIVERS, harness.DRIVER, harness.idle_tuner)
    monkeypatch.setattr(signal, "POOL_BLOCKS", 4)
    monkeypatch.setattr(harness, "WARM_BLOCKS", 2)
    monkeypatch.setattr(check, "COMPARED_LATEST", 2)
    monkeypatch.setattr(check, "COMPARED_SAMPLED", 3)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "benchmark" / "configs" / "headline_u8.json")
                     .read_text())
    cfg["topology"]["tuners"][0].update(capacity=16, engine="channelized")
    tr = json.loads((REPO / "benchmark" / "traffic" / "live.json")
                    .read_text())
    tr.update(listeners=2, squelched_listeners=0)
    root = tmp_path / "bench"
    for sub in ("configs", "traffic"):
        (root / "benchmark" / sub).mkdir(parents=True)
    (root / "benchmark" / "metrics").symlink_to(REPO / "benchmark"
                                                / "metrics")
    (root / "benchmark" / "configs" / "t.json").write_text(json.dumps(cfg))
    (root / "benchmark" / "traffic" / "t.json").write_text(json.dumps(tr))
    bench["configs"] = [{"name": "t", "source": "a test",
                         "file": "benchmark/configs/t.json", "reduced": [],
                         "why": "a test"}]
    bench["workloads"] = [{"name": "t.live", "config": "t", "traffic": "t",
                           "chips": 1, "why": "a test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = ["t.live"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.find_cell("t.live", root)
    run = harness.Run(cell, 2**31 + 7, 1.0, False, device="cpu")
    run.setup()
    run.go()
    probe = run.probe
    rec = next(iter(trace.recorders().values()))
    rows = {int(r[0]) - 1: dict(zip(trace.FIELDS, map(int, r)))
            for r in rec.rows()}
    served = [s for s in probe.served if s >= 0]
    assert served and served == sorted(served)
    assert all(rows[s]["dispatch1"] > 0 for s in served)
    assert [s for s in rows if rows[s]["dispatch1"]] == served
    for s in probe.published:
        assert rows[s]["publish1"] > 0
    delivered = [s for s, b in probe.blocks.items() if b.delivered]
    assert delivered and all(rows[s]["deliver1"] > 0 for s in delivered)
    assert {s for s in rows if rows[s]["deliver1"]} == set(delivered)
    for s in delivered:
        # the program's dispatch holds the harness's wrapper of the call
        b, r = probe.blocks[s], rows[s]
        assert r["dispatch0"] <= b.dispatch[0] * 1e9 + 1e3
        assert b.dispatch[1] * 1e9 <= r["dispatch1"] + 1e3
        # the program hands a block on inside the call the harness times,
        # and its delivery is the span of _deliver_rows inside the
        # harness's wrapper of it
        assert r["handoff1"] <= b.handed * 1e9 + 1e3
        assert b.delivered[0] * 1e9 <= r["deliver0"] + 1e3
        assert r["deliver1"] <= b.delivered[1] * 1e9 + 1e3


def gate_doc(shift_us=0.0, blocks=20):
    """A ``/profile`` trace of ``blocks`` blocks as the card gives it: a
    graph launch inside each block's dispatch span, its kernels after, the
    block's fetch ending after the next block's step; the host's tracks
    moved by ``shift_us``."""
    events = []
    for b in range(blocks):
        t = 1000.0 * b
        events.append({"ph": "X", "pid": trace.HOST_PID, "tid": 1,
                       "name": "dispatch", "ts": t + shift_us, "dur": 300.0,
                       "args": {"block": b}})
        events.append({"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1,
                       "name": "cudaGraphLaunch", "ts": t + 200.0,
                       "dur": 20.0, "args": {"correlation": b}})
        for k in range(3):
            events.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
                           "name": f"k{k}", "ts": t + 250.0 + 100 * k,
                           "dur": 90.0, "args": {"correlation": b}})
        events.append({"ph": "X", "pid": trace.HOST_PID, "tid": 2,
                       "name": "fetch", "ts": t + 1300.0 + shift_us,
                       "dur": 500.0, "args": {"block": b}})
    return {"traceEvents": events}


@pytest.mark.parametrize("shift_us,passes", [(0.0, True), (-100.0, True),
                                             (5000.0, False),
                                             (-600.0, False)])
def test_the_smokes_clock_gate_on_a_synthetic_trace(shift_us, passes):
    """Host tracks that agree with the card's clock pass; tracks moved by
    five block periods leave the first launches in no dispatch span, and
    tracks moved past the launch leave every one."""
    import chip_smoke

    gate = chip_smoke.clock_gate(gate_doc(shift_us))
    assert gate["traced"] == 20
    assert (gate["share"] >= chip_smoke.CLOCK_GATE_SHARE) == passes
    if passes:
        assert gate["share"] == 1.0 and gate["fetch_checked"] == 19
