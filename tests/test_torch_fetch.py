"""Where a served block's listened rows leave the card, on the CPU.

On the card each block's outputs come back from the pipeline with an event
recorded just after the block's own step (``pipeline.frontend.Outputs``),
and the outputs' ``select_rows`` gathers the rows on the card's copy stream
behind that event (``pipeline.frontend.behind``) and queues their copy to
the host right behind on the same stream (``SelectedRows``); the fan-out
waits for that copy. Here:

- blocks with a retune between them, through ``run_once`` and the fan-out's
  own thread, on the channelized, direct and sharded engines: each publish
  carries the block dispatched one call before, the fan-out delivers the
  blocks in that order, and the rows are byte for byte those of the plain
  path (each block's outputs' rows fetched as the pipeline hands them
  back); every fetch counts ``fetch_ready`` (1 off the card) and
  ``/status`` shows its mean;
- every engine's rows, of one block and of a backlog, against those rows
  of the whole audio in channel-major layout;
- :func:`behind` with stand-in streams and events: the copy stream waits on
  the block's event alone, reads the outputs after that, and the serving
  stream waits for the read on the card, with no wait on the host;
- the ready events a pipeline records (one a card, on the card's serving
  stream, each card's copy stream made once at the high priority) with
  stand-ins for the CUDA calls, and none off the card;
- off the card, outputs with no ready event, whose rows are the gathered
  tensors themselves.
"""

import threading
import time

import numpy as np
import pytest
import torch

from webradio_tpu_torch import radio, trace
from webradio_tpu_torch.io.source import SampleSource
from webradio_tpu_torch.io.tuner import Tuner
from webradio_tpu_torch.parallel import mesh as pmesh
from webradio_tpu_torch.parallel import sharded
from webradio_tpu_torch.pipeline import frontend
from webradio_tpu_torch.web.audiostream import AudioStreamManager

CHAIN = dict(sample_rate=1_024_000, channel_rate=128_000, audio_rate=32_000,
             block_frames=10_240)
BLOCKS = 6
#: the block before which the retune lands
RETUNE_AT = 3


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


class Sink:
    def __init__(self):
        self.rows = []

    def write(self, row):
        self.rows.append(np.array(row, copy=True))

    def close(self):
        pass


@pytest.fixture
def clean():
    trace.clear()
    yield
    radio.Radio.reset()
    AudioStreamManager.reset()
    trace.clear()


def block(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, CHAIN["block_frames"])).astype(
        np.float32) * 0.1


def front_end(engine, monkeypatch, positions=4):
    """A front end on the CPU with three listened FM receivers, each with
    a sink; not started. The sharded engine runs over ``positions`` CPU
    positions."""
    if engine == "sharded":
        monkeypatch.setattr(
            pmesh, "visible_devices",
            lambda device=None: [torch.device("cpu")] * positions)
    capacity = 4 if engine == "direct" else 16
    fe = radio.FrontEnd(Tuner(IdleSource()), radio.ChainConfig(**CHAIN),
                        capacity=capacity, engine=engine, device="cpu")
    sinks, rxs = [], []
    for k, slot in enumerate((0, capacity // 2 - 1, capacity - 1)):
        rx = radio.Receiver()
        rx.update(if_frequency=40_000 * k - 40_000, demodulator="FM")
        rx.front_end = fe
        fe._slots[slot] = rx
        rx.audio_sink = Sink()
        sinks.append(rx.audio_sink)
        rxs.append(rx)
    fe.rebuild_params()
    fe.apply_control()
    return fe, rxs, sinks


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


def delivered(fe, bid, timeout=10.0):
    """Wait until the fan-out has stamped block ``bid``'s delivery."""
    deadline = time.monotonic() + timeout
    col = trace.COLUMN["deliver1"]
    while time.monotonic() < deadline:
        rows = fe.trace.rows(bid, bid + 1)
        if len(rows) and rows[0][col]:
            return
        time.sleep(0.005)
    raise AssertionError(f"block {bid} was not delivered")


def retune(rx):
    rx.update(if_frequency=rx.if_frequency + 12_000)


@pytest.mark.parametrize("engine", ["channelized", "direct", "sharded"])
def test_each_publish_carries_the_block_before_and_rows_match_the_plain_path(
        clean, monkeypatch, engine):
    fe, rxs, sinks = front_end(engine, monkeypatch)
    ref, ref_rxs, ref_sinks = front_end(engine, monkeypatch)
    rows = tuple(i for i, rx in enumerate(ref._slots) if rx is not None)
    join = fanout(fe)
    handed = []
    put = fe._fanout.put

    def record(item):
        handed.append(list(item.ids))
        put(item)

    fe._fanout.put = record
    try:
        for k in range(BLOCKS):
            if k == RETUNE_AT:
                retune(rxs[1])
                retune(ref_rxs[1])
            fe.ring.put(block(k))
            assert fe.run_once(timeout=1.0)
            if k:
                delivered(fe, fe.trace.next_id - 2)
            # the plain path: the outputs as the pipeline hands them back,
            # fetched on the stream's own order
            ref.apply_control()
            out = ref.pipeline.process_host(block(k))
            if out is not None:
                ref._deliver_rows(rows, out.select_rows(rows).to_host())
    finally:
        join()
    # a publish hands on the block dispatched one call before, one a call
    first = fe.trace.next_id - BLOCKS
    assert handed == [[first + k] for k in range(BLOCKS - 1)]
    got = fe.trace.rows(first)
    col = {name: got[:, trace.COLUMN[name]] for name in trace.FIELDS}
    for k in range(BLOCKS - 1):
        # block k's publish follows block k + 1's dispatch
        assert col["publish0"][k] >= col["dispatch1"][k + 1] > 0
    done = col["deliver1"][:-1]
    assert (np.diff(done) > 0).all() and col["deliver1"][-1] == 0
    assert (col["fetch_ready"][:-1] == 1).all()
    assert fe.trace.summary()["fetch_ready"] == 1.0
    for mine, plain in zip(sinks, ref_sinks):
        assert len(mine.rows) == len(plain.rows) == BLOCKS - 1
        for a, b in zip(mine.rows, plain.rows):
            assert a.tobytes() == b.tobytes()


def test_cpu_outputs_carry_no_ready_event_and_their_rows_are_the_tensors(
        clean, monkeypatch):
    fe, _, sinks = front_end("channelized", monkeypatch)
    pipe = fe.pipeline
    assert pipe.process_host(block(0)) is None
    out = pipe.process_host(block(1))
    assert isinstance(out, frontend.Outputs) and out.ready == {}
    assert out.time_major and out.channels == 16
    rows = (0, 7, 15)
    want = out[0].T[list(rows)].numpy()
    [(gathered, got_rows)] = fe._publish(out)
    assert isinstance(gathered, frontend.SelectedRows) and got_rows == rows
    assert gathered.ready == {} and gathered.copied == []
    assert gathered.is_ready()
    np.testing.assert_array_equal(gathered.to_host(), want)
    assert np.abs(want).max() > 0
    flushed = pipe.flush()
    assert isinstance(flushed, frontend.Outputs) and flushed.ready == {}
    synced = pipe.process_host_sync(block(2))
    assert isinstance(synced, frontend.Outputs)


@pytest.mark.parametrize("backlog", [False, True], ids=["block", "backlog"])
@pytest.mark.parametrize("engine", ["direct", "channelized", "sharded"])
def test_every_engines_rows_are_those_of_the_whole_audio(
        clean, monkeypatch, engine, backlog):
    """``Outputs.select_rows(rows).to_host()`` of one block, and of a
    ``process_host_many`` backlog of three, against those rows of the
    whole audio in channel-major layout; the sharded engine on a (1, 2)
    CPU mesh, its rows from both shards."""
    fe, _, _ = front_end(engine, monkeypatch, positions=2)
    pipe = fe.pipeline
    c = fe.cfg.num_channels
    if engine == "sharded":
        assert pipe.mesh.shape == {"time": 1, "chan": 2}
    if backlog:
        assert pipe.process_host_many(np.stack(
            [block(k) for k in range(3)])) is None
        out = pipe.flush()
    else:
        out = pipe.process_host_sync(block(0))
    assert out.channels == c
    audio = out[0]
    if engine == "sharded":
        whole = audio.full().numpy()
    else:
        whole = (audio.movedim(-1, -2) if out.time_major else audio).numpy()
    assert whole.shape[-2] == c
    assert whole.ndim == (3 if backlog else 2)
    rows = [c - 1, 0, c // 2 - 1, c // 2]  # the three listened, one muted
    got = out.select_rows(rows).to_host()
    np.testing.assert_array_equal(got, whole[..., rows, :])
    assert np.abs(got[..., :3, :]).max() > 0


# ---- stand-ins for the CUDA calls ----------------------------------------
class Log(list):
    def add(self, *what):
        self.append(what)


class FakeEvent:
    made = 0

    def __init__(self, log):
        FakeEvent.made += 1
        self.log, self.name = log, f"event{FakeEvent.made}"

    def record(self, stream=None):
        self.log.add("record", self.name, stream.name)

    def query(self):
        return True

    def synchronize(self):
        self.log.add("host waits", self.name)


class FakeStream:
    def __init__(self, name, device, log, priority=0):
        self.name, self.device, self.log = name, device, log
        self.priority = priority

    def wait_event(self, event):
        self.log.add("wait", self.name, event.name)


class FakeSource:
    def __init__(self, log):
        self.log = log

    def record_stream(self, stream):
        self.log.add("keep", stream.name)


def fake_cuda(monkeypatch, log, current):
    """``torch.cuda``'s events, streams and stream context as stand-ins that
    write what they are asked into ``log``; ``current`` is the stream the
    context holds (a one-item list)."""
    streams = {}

    class Context:
        def __init__(self, stream):
            self.stream = stream

        def __enter__(self):
            self.prev = current[0]
            current[0] = self.stream
            log.add("enter", self.stream.name)

        def __exit__(self, *exc):
            current[0] = self.prev
            log.add("leave", self.stream.name)

    def make_stream(device, priority=0):
        s = FakeStream(f"copy{len(streams)}", device, log, priority)
        streams[s.name] = s
        return s

    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: FakeEvent(log))
    monkeypatch.setattr(torch.cuda, "Stream", make_stream)
    monkeypatch.setattr(torch.cuda, "stream", Context)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: current[0])
    return streams


def test_behind_waits_on_the_blocks_event_alone_and_never_on_the_host(
        monkeypatch):
    log = Log()
    serving = FakeStream("serving", torch.device("cuda", 0), log)
    current = [serving]
    fake_cuda(monkeypatch, log, current)
    copy = FakeStream("copy", serving.device, log)
    ready = FakeEvent(log)
    with frontend.behind((ready, copy), [FakeSource(log)]):
        log.add("gather on", current[0].name)
    read = log[-1][2]
    assert log == [("wait", "copy", ready.name),
                   ("keep", "copy"),
                   ("enter", "copy"),
                   ("gather on", "copy"),
                   ("leave", "copy"),
                   ("record", read, "copy"),
                   ("wait", "serving", read)]
    log.clear()
    with frontend.behind(None, [FakeSource(log)]):
        log.add("gather on", current[0].name)
    assert log == [("gather on", "serving")]


@pytest.mark.parametrize("cards", [1, 4])
def test_a_pipeline_records_one_ready_event_a_card_after_its_step(
        monkeypatch, cards):
    log = Log()
    devices = [torch.device("cuda", d) for d in range(cards)]
    serving = {d: FakeStream(f"serving{d.index}", d, log) for d in devices}
    made = fake_cuda(monkeypatch, log, [None])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: serving[device])
    pipe = object.__new__(sharded.ShardedPipeline if cards > 1
                          else frontend.HostPipeline)
    pipe.device, pipe.devices = devices[-1], devices
    pipe._copy_streams, pipe._pending = {}, None
    assert pipe.cards() == devices
    assert pipe._swap_pending("audio", "db") is None
    first = pipe._swap_pending("audio2", "db2")
    assert tuple(first) == ("audio", "db")
    assert list(first.ready) == devices
    for dev, (event, copy) in first.ready.items():
        assert ("record", event.name, f"serving{dev.index}") in log
        assert copy.device == dev and copy.priority < 0
    # the copy streams are made once, one a card
    assert len(made) == cards
    second = pipe.flush()
    assert [c for _, c in second.ready.values()] == [
        c for _, c in first.ready.values()]
    assert not any(entry[0] == "host waits" for entry in log)


def test_off_the_card_a_pipeline_records_no_event(clean, monkeypatch):
    fe, _, _ = front_end("sharded", monkeypatch)
    assert fe.pipeline.cards() == []
    assert fe.pipeline.process_host(block(0)) is None
    out = fe.pipeline.process_host(block(1))
    assert isinstance(out, frontend.Outputs) and out.ready == {}
    sel = out.select_rows([0, 5])
    assert isinstance(sel, sharded.SelectedRows) and sel.copied == []
    assert sel.ready == {} and sel.is_ready()
    np.testing.assert_array_equal(sel.to_host(), out[0].fetch_rows([0, 5]))
