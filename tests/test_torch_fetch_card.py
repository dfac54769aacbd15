"""The fan-out's fetch on the card (``cuda``-marked: each test skips itself
where torch sees no card, the sharded one below two cards). No JAX here,
so the file runs on the card's machine with ``--noconftest -m cuda``
(README).

A block's listened rows are gathered and copied to the host on the card's
copy stream behind the block's own step, not behind the serving stream. A
long sleep is queued on every card's serving stream right after the next
block's dispatch: the fetch of the block's rows (the pump's publish
queues the gather and the copy, the fan-out waits) returns before the
sleep ends, the pump's next call
returns before it too (the pump waits on no card), and the rows equal
those fetched alone from a copy of the same outputs with no ready event
(``Outputs.select_rows``, on the serving stream's own order) once the card
is idle.
"""

import threading

import numpy as np
import pytest
import torch

from webradio_tpu_torch import radio, trace
from webradio_tpu_torch.io.source import SampleSource
from webradio_tpu_torch.io.tuner import Tuner
from webradio_tpu_torch.parallel.sharded import ShardedAudio
from webradio_tpu_torch.pipeline.frontend import Outputs
from webradio_tpu_torch.web.audiostream import AudioStreamManager

#: the sleep queued on each serving stream: about a second at the H100's
#: clocks, hundreds of times a block's step at these widths
SLEEP_CYCLES = 2_000_000_000
BLOCK_FRAMES = 102_400


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
    def write(self, row):
        pass

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
    return rng.standard_normal((2, BLOCK_FRAMES)).astype(np.float32) * 0.1


def listened_front_end(engine, capacity, slots):
    """A front end on the cards with an FM receiver and a sink in each of
    ``slots``; not started."""
    fe = radio.FrontEnd(Tuner(IdleSource()),
                        radio.ChainConfig(block_frames=BLOCK_FRAMES),
                        capacity=capacity, engine=engine)
    for k, slot in enumerate(slots):
        rx = radio.Receiver()
        rx.update(if_frequency=25_000 * k - 300_000, demodulator="FM")
        rx.front_end = fe
        fe._slots[slot] = rx
        rx.audio_sink = Sink()
    fe.rebuild_params()
    fe.apply_control()
    return fe


def copied(out):
    """A copy of a block's outputs with no ready event, each piece of its
    audio copied on its own card's current stream."""
    audio = out[0]
    if isinstance(audio, ShardedAudio):
        audio = ShardedAudio(audio.mesh, [
            {p: a.clone() for p, a in pieces.items()}
            for pieces in audio.blocks], audio.time_major)
    else:
        audio = audio.clone()
    return Outputs(audio, out[1], time_major=out.time_major)


def fetch_behind_a_sleep(fe):
    """Blocks 0 to 3 through ``run_once``, a sleep on every card's serving
    stream after block 2's dispatch; block 1's rows fetched as the fan-out
    fetches them, then alone from the same outputs."""
    pipe = fe.pipeline
    outs = []
    process_host = pipe.process_host

    def kept(planes):
        out = process_host(planes)
        outs.append(out)
        return out

    pipe.process_host = kept
    cards = pipe.cards()
    assert cards
    for k in range(2):  # the warm and capture, then block 0's rows
        fe.ring.put(block(k))
        assert fe.run_once(timeout=30.0)
    for gathered, _ in fe._fanout.get(timeout=0):
        gathered.to_host()
    fe.ring.put(block(2))
    assert fe.run_once(timeout=30.0)
    slept = []
    for dev in cards:
        with torch.cuda.device(dev):
            torch.cuda._sleep(SLEEP_CYCLES)
            event = torch.cuda.Event()
            event.record()
            slept.append(event)
    item = fe._fanout.get(timeout=0)
    assert item.ids == [fe.trace.next_id - 2]
    [(gathered, rows)] = item
    got = gathered.to_host()
    fetched_first = not any(e.query() for e in slept)
    assert gathered.is_ready()
    # block 1's outputs (handed back by block 2's call), copied on the
    # serving streams before block 3's replay rewrites them
    alone = copied(outs[2])
    fe.ring.put(block(3))
    assert fe.run_once(timeout=30.0)
    pumped_first = not any(e.query() for e in slept)
    for dev in cards:
        torch.cuda.synchronize(dev)
    assert fetched_first, "the fetch waited for the next block's step"
    assert pumped_first, "the pump waited on a card"
    want = alone.select_rows(rows).to_host()
    assert got.shape == (len(rows), want.shape[-1])
    assert got.tobytes() == want.tobytes()
    assert np.abs(got).max() > 0


@pytest.mark.cuda
def test_a_blocks_rows_leave_the_card_before_the_next_step_ends(clean):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fe = listened_front_end("channelized", 1_024, (3, 500, 1_023))
    fetch_behind_a_sleep(fe)


@pytest.mark.cuda
def test_each_cards_rows_leave_it_before_the_next_step_ends(clean):
    """The sharded engine over every card, two listened rows a card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    n = torch.cuda.device_count()
    per = 1_024
    fe = listened_front_end("sharded", per * n,
                            [c * per + j for c in range(n) for j in (1, 700)])
    assert len(fe.pipeline.cards()) == n
    fetch_behind_a_sleep(fe)
