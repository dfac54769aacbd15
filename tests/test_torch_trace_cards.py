"""The flight recorder on a sharded front end (``webradio_tpu_torch.trace``)
on the CPU: every block's round of launches (``launch0`` to ``launch1``)
inside its dispatch, and the slowest and fastest card's step
(``step_ns``, ``step_min_ns``) from one timing-event pair a card, each
recorded around that card's own replays of the round, shown by
``/status``; a single-card front end leaves those fields 0. Then the
``wide_highest4.bulk`` cell's readers on a recorder and a four-card device
timeline made by hand: its two readers of the recorder (None on a
recorder without their fields) and the accepted device readers it shares
with ``headline_u8.bulk``, and the cell found by name.

The sharded front ends run the channelized engine over a (time=1, chan=4)
mesh of CPU positions (``parallel.mesh.visible_devices`` replaced, as
``tests/test_torch_sharded.py`` builds its meshes). A card test
(``cuda``-marked, below two cards it skips) times a sharded front end
over every card.
"""

import json
import pathlib
import threading
import types

import numpy as np
import pytest
import torch

from webradio_tpu_torch import radio, trace
from webradio_tpu_torch.io.source import SampleSource
from webradio_tpu_torch.io.tuner import Tuner
from webradio_tpu_torch.parallel import mesh as pmesh
from webradio_tpu_torch.web.audiostream import AudioStreamManager

torch.sin(torch.zeros(1))  # the first multi-threaded sin of a process

REPO = pathlib.Path(__file__).resolve().parents[1]
CHAIN = dict(sample_rate=1_024_000, channel_rate=128_000, audio_rate=32_000,
             block_frames=10_240)
NEW = ("step_min_ns", "launch0", "launch1")


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


def sharded_front_end(monkeypatch, capacity=16, positions=4):
    """A sharded front end over ``positions`` CPU positions, one listened
    receiver a position; not started."""
    monkeypatch.setattr(pmesh, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * positions)
    fe = radio.FrontEnd(Tuner(IdleSource()), radio.ChainConfig(**CHAIN),
                        capacity=capacity, engine="sharded", device="cpu")
    per = capacity // positions
    for p in range(positions):
        rx = radio.Receiver()
        rx.update(if_frequency=20_000 * p - 30_000, demodulator="FM")
        rx.front_end = fe
        fe._slots[p * per + 1] = rx
        AudioStreamManager.subscribe(rx.uuid, "wav", CHAIN["audio_rate"])
    fe.rebuild_params()
    fe.apply_control()
    return fe


def block(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, CHAIN["block_frames"])) * 0.1).astype(
        np.float32)


def rows_by_id(fe) -> dict:
    return {int(r[0]) - 1: dict(zip(trace.FIELDS, map(int, r)))
            for r in fe.trace.rows()}


def test_the_sharded_recorder_stamps_launches_and_both_steps(clean,
                                                             monkeypatch):
    fe = sharded_front_end(monkeypatch)
    assert fe.pipeline.mesh.shape == {"time": 1, "chan": 4}
    for k in range(4):
        fe.ring.put(block(k))
        assert fe.run_once(timeout=1.0)
    rows = rows_by_id(fe)
    assert sorted(rows) == [0, 1, 2, 3]
    for bid, r in rows.items():
        assert 0 < r["dispatch0"] <= r["launch0"] <= r["launch1"] \
            <= r["dispatch1"], bid
        assert 0 < r["step_min_ns"] <= r["step_ns"], bid
    s = fe.trace.summary()
    assert s["launch_ms"]["p50"] > 0 and s["step_min_ms"]["p50"] > 0
    assert s["step_min_ms"]["p50"] <= s["step_ms"]["p50"]


def test_a_single_card_front_end_leaves_the_new_fields_zero(clean):
    fe = radio.FrontEnd(Tuner(IdleSource()), radio.ChainConfig(**CHAIN),
                        capacity=2, engine="direct", device="cpu")
    fe.rebuild_params()
    for k in range(3):
        fe.ring.put(block(k))
        assert fe.run_once(timeout=1.0)
    for r in rows_by_id(fe).values():
        assert r["step_ns"] > 0 and all(r[f] == 0 for f in NEW)
    s = fe.trace.summary()
    assert s["launch_ms"] is None and s["step_min_ms"] is None
    assert fe.card_steps_ns == []


class _Stream:
    """A card's stream as the timing events see it: a clock that each
    block's stages advance by the card's own step."""

    def __init__(self, step_ns):
        self.t, self.step_ns = 0, step_ns


class _Event:
    """``torch.cuda.Event`` with the stream's clock as its time."""

    def __init__(self, enable_timing=False):
        self.t = 0

    def record(self, stream):
        self.t = stream.t

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def test_each_cards_event_pair_gives_the_slowest_and_the_fastest_step(
        clean, monkeypatch):
    """With a pair of timing events on each card's stream (stand-ins of
    three cards whose steps take 3, 7 and 5 ms), handed to the block's run
    and recorded around its stages, the recorder's ``step_ns`` is the
    slowest card's, ``step_min_ns`` the fastest's, and ``card_steps_ns``
    each card's, in the cards' order; ``/status`` shows them."""
    from webradio_tpu_torch.parallel import graphs
    from webradio_tpu_torch.web import handlers

    fe = sharded_front_end(monkeypatch)
    steps = [3_000_000, 7_000_000, 5_000_000]
    streams = [_Stream(ns) for ns in steps]

    cards = [torch.device("cpu", k) for k in range(3)]
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: streams[device.index])
    monkeypatch.setattr(fe.pipeline, "cards", lambda: cards)
    monkeypatch.setattr(fe.pipeline, "_ready", dict)  # no copy streams
    eager = graphs.BlockProgram._eager

    def stages(program, pipe, slot):
        eager(program, pipe, slot)
        for s in streams:
            s.t += s.step_ns  # the card's share of the block

    monkeypatch.setattr(graphs.BlockProgram, "_eager", stages)
    for k in range(3):
        fe.ring.put(block(k))
        assert fe.run_once(timeout=1.0)
    for r in rows_by_id(fe).values():
        assert r["step_ns"] == max(steps) and r["step_min_ns"] == min(steps)
        assert 0 < r["launch0"] <= r["launch1"]
    assert fe.card_steps_ns == steps
    assert fe.pipeline.step_events is None  # taken by each block's run
    status = handlers.StatusHandler.__new__(handlers.StatusHandler)
    sent = {}
    status.send_json = lambda obj: sent.update(obj) or 200
    status.do_get({}, b"")
    got = sent["front_ends"][fe.uuid]
    assert got["card_step_ms"] == [3.0, 7.0, 5.0]
    assert got["last_step_ms"] == 7.0
    assert got["trace"]["step_ms"]["p50"] == 7.0
    assert got["trace"]["step_min_ms"]["p50"] == 3.0
    assert got["trace"]["launch_ms"]["p50"] >= 0
    assert got["ns_per_frame"] == pytest.approx(7e6 / CHAIN["block_frames"],
                                                abs=0.1)


def test_a_segmented_round_marks_each_devices_first_and_last_replay(
        monkeypatch):
    """On graphs in the segmented plan (one graph a device and segment,
    the moves between them), the round's marks name each graph's device
    and flag its device's first and last replay; a move carries none."""
    from tests.torch_graph_standin import RecordedGraph
    from webradio_tpu_torch.parallel import graphs

    fe = sharded_front_end(monkeypatch)
    pipe = fe.pipeline
    pipe.graph_class = RecordedGraph
    pipe.segmented = True
    for k in range(2):
        pipe.process_host_sync(block(k))
    program = pipe._program
    assert program.rounds is not None
    (dev,) = program.by_device
    graphed = [i for i, item in enumerate(program.rounds[0])
               if not isinstance(item, graphs.Move)]
    assert len(graphed) >= 2 and len(program.marks) == len(program.rounds[0])
    for i, (d, first, last) in enumerate(program.marks):
        if i in graphed:
            assert d == dev
            assert (first, last) == (i == graphed[0], i == graphed[-1])
        else:
            assert (d, first, last) == (None, False, False)


def test_each_cards_pair_is_recorded_around_its_own_replays(monkeypatch):
    """A round over three cards (a move, then each card's graph, a move,
    then each card's graph again): a card's start event comes just before
    its first replay and its end just after its last, on its own stream,
    and nothing else is recorded; the launch span covers the replays."""
    from webradio_tpu_torch.parallel import graphs

    log = []
    cards = [torch.device("cpu", k) for k in range(3)]

    class Replay:
        def __init__(self, k):
            self.k = k

        def replay(self):
            log.append(("replay", self.k))

    class Mark:
        def __init__(self, what, k):
            self.what, self.k = what, k

        def record(self, stream):
            log.append((self.what, self.k, stream))

    move = graphs.Move(lambda ws: log.append(("move",)))
    program = graphs.BlockProgram.__new__(graphs.BlockProgram)
    program.graphed, program.kernels_per_block = True, 0
    program.rounds = [[move] + [Replay(k) for k in range(3)] + [move]
                      + [Replay(k) for k in range(3)]] * 2
    program.marks = ([(None, False, False)]
                     + [(d, True, False) for d in cards]
                     + [(None, False, False)]
                     + [(d, False, True) for d in cards])
    program.outputs = [{}, {}]
    pipe = types.SimpleNamespace(
        devices=cards, cards=lambda: cards, graph_replays=0, graph_kernels=0,
        step_events=[(f"s{k}", Mark("start", k), Mark("end", k))
                     for k in range(3)])
    monkeypatch.setattr(graphs, "Workspace", lambda fe, prog, slot: None)
    program.run(pipe, 0)
    assert log == (
        [("move",)]
        + [x for k in range(3) for x in (("start", k, f"s{k}"),
                                         ("replay", k))]
        + [("move",)]
        + [x for k in range(3) for x in (("replay", k),
                                         ("end", k, f"s{k}"))])
    assert pipe.step_events is None and pipe.graph_replays == 1
    assert 0 < program.launched[0] <= program.launched[1]


# ---- the wide cell's readers ---------------------------------------------
def synthetic_cards(key="cards", n=10, period_ns=25_000_000,
                    t0_ns=1_000_000_000):
    """A sharded front end's recorder of ``n`` blocks a ``period_ns``
    apart: block k's slowest card 24 + k/10 ms, its fastest 20 ms, its
    launches 1 + k/10 ms."""
    rec = trace.Recorder(key)
    trace._recorders[key] = rec
    ms = 1_000_000
    for k in range(n):
        t = t0_ns + k * period_ns
        rec.begin(k, t, 1)
        rec.got(k, t + ms // 100, 0, 1)
        rec.dispatched(k, t + ms // 10, t + 2 * ms // 10, t + 3 * ms // 10,
                       t + 3 * ms)
        rec.launched(k, t + ms // 2, t + ms // 2 + ms + k * ms // 10)
        rec.step(k, 24 * ms + k * ms // 10, 20 * ms)
    return rec


def reader(name):
    from benchmark import registry

    return registry.load_reader(REPO / "benchmark" / "metrics"
                                / f"{name}.py")


def timeline_of_four():
    """Four cards over a window [1.0, 1.1) s: busy 90, 80, 70 and 60 ms."""
    from benchmark.profile import Timeline

    events = [(1.0, 1.0 + 0.01 * (9 - d), d, "k") for d in range(4)]
    return Timeline(events, 1.0, 1.1)


def run_view(window=(1.05, 1.2), timeline=None, dispatched=4):
    from benchmark import roofline

    return types.SimpleNamespace(
        window=window, timeline=timeline, dispatched=[None] * dispatched,
        step_bound_ms=lambda: roofline.roofline_ms(65_536,
                                                   "highest")["ideal_ms"])


WIDE = {
    # blocks 2..7 are dispatched in [1.05, 1.2)
    "card_step_ms.bulk": lambda: float(np.median(
        [24 + k / 10 for k in range(2, 8)])),
    "launch_spread_ms.bulk": lambda: float(np.median(
        [1 + k / 10 for k in range(2, 8)])),
}


@pytest.mark.parametrize("name", sorted(WIDE))
def test_each_wide_reader_on_a_synthetic_recorder(clean, name):
    synthetic_cards()
    got = reader(name).read(run_view(timeline=timeline_of_four()))
    assert got == pytest.approx(WIDE[name](), rel=1e-9)


@pytest.mark.parametrize("name", sorted(WIDE))
def test_each_wide_reader_is_none_without_the_new_fields(clean, name,
                                                          monkeypatch):
    """On a recorder whose table has no per-card step or launch span (the
    program before them): None, and no error."""
    synthetic_cards()
    old = {k: v for k, v in trace.COLUMN.items() if k not in NEW}
    monkeypatch.setattr(trace, "COLUMN", old)
    assert reader(name).read(run_view(timeline=timeline_of_four())) is None


@pytest.mark.parametrize("name", ["card_step_ms.bulk",
                                  "launch_spread_ms.bulk"])
def test_a_single_card_recorder_reads_none(clean, name):
    """A single-card front end's rows leave the fields 0: nothing to
    read."""
    rec = synthetic_cards()
    rec.table[:, trace.COLUMN["step_min_ns"]] = 0
    rec.table[:, trace.COLUMN["launch0"]] = 0
    assert reader(name).read(run_view()) is None


TAIL = "void (anonymous namespace)::tail_tm_kernel<true, 0, 0, 3>(...)"


def four_cards_at_work():
    """Four cards over a window [1.0, 1.1) s, a block each 25 ms from
    1.0 s (``synthetic_cards``' dispatches): card d idle for the block's
    first 3 ms, then a GEMM of 15 - d ms and kernel #1 of 7 ms."""
    from benchmark.profile import Timeline

    events = []
    for k in range(4):
        t = 1.0 + 0.025 * k + 0.003
        for d in range(4):
            gemm = 0.015 - 0.001 * d
            events += [(t, t + gemm, d, "sgemm"),
                       (t + gemm, t + gemm + 0.007, d, TAIL)]
    return Timeline(events, 1.0, 1.1)


def wide_view():
    from benchmark.tracing import RunView

    return RunView(window=(1.0, 1.1), blocks=[], dispatched=[None] * 4,
                   pump_calls=[], listeners=8,
                   timeline=four_cards_at_work(),
                   channels_per_card=262_144 // 4, pfb_precision="highest")


SHARED = {
    # the busiest card is card 0: 22 ms busy a block, #1 7 ms of it
    "step_roofline.bulk": lambda v: 100 * v.step_bound_ms() / 22.0,
    "tail_roofline.bulk": lambda v: 100 * v.tail_bound_ms() / 7.0,
    "idle_share.bulk": lambda v: 100 * (1 - 4 * 0.022 / 0.1),
    # its idle 3 ms a block holds control (0.1 ms) and dispatch (2.7 ms)
    "idle_host_share.bulk": lambda v: 100 * 2.8 / 3.0,
}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_each_shared_reader_reads_the_busiest_of_four_cards(clean, name):
    """The accepted device readers the wide cell shares with
    ``headline_u8.bulk`` read its four-card timeline at the busiest card
    and one card's share of the capacity, and need nothing the program
    before the per-card step lacks."""
    synthetic_cards()
    view = wide_view()
    assert reader(name).read(view) == pytest.approx(SHARED[name](view),
                                                    rel=1e-6)


def test_the_wide_cell_is_found_by_name():
    from benchmark import registry

    cell = registry.find_cell("wide_highest4.bulk", REPO)
    assert cell.chips == 4
    assert {m.name for m in cell.end_to_end} == {"rt_factor", "setup_s"}
    assert {m.name for m in cell.per_layer} == set(WIDE) | set(SHARED)
    tuner = cell.tuner
    assert (tuner["engine"], tuner["pfb_precision"], tuner["capacity"]) == (
        "sharded", "highest", 262_144)
    assert pmesh.mesh_shape_for(4, tuner["capacity"],
                                tuner["block_frames"]) == (1, 4)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    rt = next(m for m in bench["end_to_end"] if m["name"] == "rt_factor")
    assert rt["workloads"][-1] == "wide_highest4.bulk"
    for m in bench["per_layer"]:
        if m["name"] in SHARED:
            assert m["workloads"] == ["headline_u8.bulk",
                                      "wide_highest4.bulk"]


# ---- on the cards --------------------------------------------------------
@pytest.mark.cuda
def test_a_sharded_front_end_times_every_card(clean):
    """On two or more cards: a sharded front end served through
    ``run_once`` reads a step on every card for each block, ``step_ns``
    the largest of them and ``step_min_ns`` the smallest."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    n = torch.cuda.device_count()
    fe = radio.FrontEnd(Tuner(IdleSource()), radio.ChainConfig(
        block_frames=102_400), capacity=1_024 * n, engine="sharded")
    fe.rebuild_params()
    assert len(fe.pipeline.devices) == n
    fe.pipeline.process_host_sync(np.zeros((2, 102_400), np.float32))
    fe.pipeline.reset()
    seen = {}
    for k in range(6):
        fe.ring.put(block(k).repeat(10, axis=1))
        assert fe.run_once(timeout=5.0)
        torch.cuda.synchronize()
        if fe.card_steps_ns:
            seen[fe.trace.next_id] = list(fe.card_steps_ns)
    for d in range(n):
        torch.cuda.synchronize(d)
    rows = rows_by_id(fe)
    read = [r for r in rows.values() if r["step_ns"]]
    assert len(read) >= 4
    for r in read:
        assert 0 < r["step_min_ns"] <= r["step_ns"]
        assert 0 < r["launch0"] <= r["launch1"] <= r["dispatch1"]
    assert seen and all(len(v) == n and all(x > 0 for x in v)
                        for v in seen.values())
    last = max(bid for bid, r in rows.items() if r["step_ns"])
    assert rows[last]["step_ns"] == max(fe.card_steps_ns)
    assert rows[last]["step_min_ns"] == min(fe.card_steps_ns)
