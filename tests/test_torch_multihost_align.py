"""The multihost ranks agree on the source block of every round
(``radio.FrontEnd._agreed_block``, ``parallel.multihost.agree_index``).

Each rank of a multihost front end reads its own source and ingests its
own time slice of the block; a paced source behind a drop-oldest ring can
drop different numbers of blocks on different ranks. Every source
therefore reports ``block_index`` (the index of the block it returned
among all its producer made), and each round the ranks take the largest
index of the group, a rank behind reading ahead to it.

1. Two real processes on gloo (``tests/torch_multihost_align_worker.py``):
   one rank's source lost 4 blocks at start, the other's none; rank 0's
   gathered audio over 4 carried blocks equals the single-device step on
   the same source blocks, and where one rank's source ends both stop.
2. The round's rule without processes: a stand-in for the other rank's
   all-reduce (read ahead, agree again after an overshoot, stop where a
   source ended).
3. The index of a ring-backed source: blocks popped plus blocks dropped,
   with a drop that races the pop (the popped block is passed over), and
   the native tone session's blocks against the synthesis at their index.
"""

import collections
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from webradio_tpu_torch.io import native
from webradio_tpu_torch.io.source import (
    NativeToneSource,
    SampleSource,
    ToneSource,
)
from webradio_tpu_torch.io.tuner import Tuner
from webradio_tpu_torch.parallel import multihost
from webradio_tpu_torch.pipeline.state import ChainConfig
from webradio_tpu_torch.radio import FrontEnd, Radio

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

WORKER = pathlib.Path(__file__).parent / "torch_multihost_align_worker.py"
FRAMES = 10_240


def test_two_ranks_serve_the_same_blocks_after_unequal_drops(tmp_path):
    url = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, str(WORKER), url, str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "ALIGN_OK" in out, (
            f"rank {r} failed:\n{out[-4000:]}")


class Tagged(SampleSource):
    """Blocks whose every sample is their index; ``indices`` lists the
    index of each read (a jump is blocks the producer dropped), None the
    end of the stream."""

    def __init__(self, indices):
        super().__init__()
        self.block_frames = FRAMES
        self._indices = iter(indices)

    def read_block(self):
        k = next(self._indices, None)
        if k is None:
            return None
        return self._counted(np.full(FRAMES, k, np.complex64),
                             k - self._reads)


class OtherRank:
    """The all-reduce of ``agree_index`` with one more rank, whose index
    (or ``"ended"``) at each call is scripted."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = []

    def __call__(self, index, ended):
        other = self.script.pop(0)
        self.calls.append((index, ended, other))
        if ended or other == "ended":
            return max(index, -1), min(index, -1), True
        return max(index, other), min(index, other), False


@pytest.fixture
def front_end():
    made = []

    def make(indices):
        fe = FrontEnd(Tuner(Tagged(indices)),
                      ChainConfig(sample_rate=1_024_000,
                                  channel_rate=128_000, audio_rate=32_000,
                                  block_frames=FRAMES),
                      capacity=4, engine="sharded", multihost=True,
                      device="cpu")
        made.append(fe)
        return fe

    yield make
    for fe in made:
        fe.close()
    Radio.reset()


@pytest.mark.parametrize("mine, other, served, skipped, calls", [
    # equal: one all-reduce, nothing passed over
    ([0, 1], [0], 0, 0, 1),
    # the other rank's ring dropped 3 more: read ahead to its index
    ([0, 1, 2, 3, 4], [3, 3], 3, 3, 2),
    # my ring drops while I read ahead (2 -> 5 overshoots 4): the other
    # rank then reads ahead to 5, and the third all-reduce agrees
    ([1, 2, 5, 6], [4, 4, 5], 5, 2, 3),
    # this rank is ahead: it waits for the other to read ahead
    ([7, 8], [5, 7], 7, 0, 2),
])
def test_round_reads_ahead_to_the_largest_index(front_end, monkeypatch,
                                                mine, other, served,
                                                skipped, calls):
    fe = front_end(mine)
    rank = OtherRank(other)
    monkeypatch.setattr(multihost, "agree_index", rank)
    block, index = fe._agreed_block()
    assert index == served and block is not None
    assert np.all(block == served)  # the block named by the index
    assert fe.tuner.block_index == served
    assert fe.skipped_blocks == skipped
    assert fe.dropped_blocks == skipped  # passed-over blocks are drops
    assert len(rank.calls) == calls and not rank.script


@pytest.mark.parametrize("mine, other", [
    ([], [3]),  # my source ended: the others learn it in the all-reduce
    ([0, 1], ["ended"]),  # another rank's source ended
    ([0, 1], [3, "ended"]),  # mine ends while it reads ahead
])
def test_round_stops_where_a_source_ended(front_end, monkeypatch, mine,
                                          other):
    fe = front_end(mine)
    rank = OtherRank(other)
    monkeypatch.setattr(multihost, "agree_index", rank)
    assert fe._agreed_block() == (None, -1)
    assert rank.calls[-1][1] or rank.calls[-1][2] == "ended"
    assert not rank.script


def test_run_once_stops_every_rank_at_the_round_a_source_ended(
        front_end, monkeypatch):
    """The round returns False without a step where the agreement says a
    source ended (the pump's loop then stops)."""
    fe = front_end([0, 1])
    fe.running = True
    fe._mh_slice = (0, FRAMES)
    fe.pipeline = None  # a step would raise
    monkeypatch.setattr(fe, "_apply_control_blob", lambda ctl: None)
    monkeypatch.setattr(fe, "_control_blob", lambda: {})
    monkeypatch.setattr(multihost, "agree_index", OtherRank(["ended"]))
    assert fe.run_once() is False
    assert not fe.running and fe.block_count == 0 and not fe.served


class RacingRing:
    """A stand-in native session: a drop-oldest ring of tagged ``[2, 4]``
    blocks whose producer pushes inside ``pop``, around the take (the
    scripted ``(before, after)`` pushes of each call), as a capture thread
    can between the reader's reads of the drop count."""

    def __init__(self, depth, script):
        self.depth, self.script = depth, list(script)
        self.q = collections.deque()
        self.made = self.dropped_blocks = 0

    def push(self):
        if len(self.q) >= self.depth:
            self.q.popleft()
            self.dropped_blocks += 1
        self.q.append(self.made)
        self.made += 1

    def pop(self, timeout=None):
        before, after = self.script.pop(0) if self.script else (1, 0)
        for _ in range(before):
            self.push()
        k = self.q.popleft() if self.q else None
        for _ in range(after):
            self.push()
        return None if k is None else np.full((2, 4), k, np.float32)


def test_native_index_passes_over_a_block_whose_drop_raced_its_pop():
    """Index = pops + drops; where a drop lands between the reads of the
    drop count around a pop (before the take or after it), the popped
    block's index is unknown: it is passed over and counted as dropped,
    and every block returned carries its true index."""
    ring = RacingRing(depth=4, script=[
        (4, 0),  # blocks 0-3 made; 0 returned
        (1, 0),  # 1
        (2, 0),  # a drop (of 2) before the take of 3: 3 passed over
        (0, 0),  # 4
        (2, 2),  # a drop (of 6) after the take of 5: 5 passed over
        (0, 0),  # 7
        (6, 0),  # five drops (8-12) before the take of 13: passed over
        (0, 0),  # 14
        (0, 0),  # 15
    ])
    src = NativeToneSource()
    src._session, src._running = ring, True
    got = []
    for _ in range(6):
        block = src.read_block()
        assert block is not None
        assert np.all(block == src.block_index), (block[0, 0],
                                                  src.block_index)
        got.append(src.block_index)
    assert got == [0, 1, 4, 7, 14, 15]
    assert src.passed_blocks == 3
    assert src.dropped_blocks == ring.dropped_blocks + 3
    # every block made was returned, passed over, dropped, or is queued
    assert ring.made == (len(got) + src.passed_blocks + ring.dropped_blocks
                         + len(ring.q))


@pytest.mark.skipif(not native.available(),
                    reason="the native ingest library did not build")
def test_native_tone_index_names_the_block_after_ring_drops():
    """The paced native tone session outruns a reader that sleeps: its ring
    drops, and each block read is the synthesis at its index (the numpy
    source's law from sample ``block_index * block_frames``)."""
    carriers = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0))
    src = NativeToneSource(carriers=carriers, noise=0.0)
    src.sample_rate, src.block_frames, src.ring_blocks = 2_048_000, 2_048, 2
    assert src.start()
    try:
        seen = []
        for _ in range(4):
            time.sleep(0.02)  # ~20 blocks made, two held
            block = src.read_block()
            ref = ToneSource(carriers=carriers, noise=0.0)
            ref.sample_rate, ref.block_frames = 2_048_000, 2_048
            ref.realtime, ref._n0 = False, src.block_index * 2_048
            want = ref.read_block()
            np.testing.assert_allclose(block[0], want.real, atol=2e-5)
            np.testing.assert_allclose(block[1], want.imag, atol=2e-5)
            seen.append(src.block_index)
        assert src.dropped_blocks > 0
        assert seen == sorted(set(seen))
    finally:
        src.stop()
