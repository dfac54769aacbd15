"""The port's own host I/O (``webradio_tpu_torch.io``) against the JAX
package's ``webradio_tpu.io``: the same seed gives bit-equal blocks, and the
ring keeps the reference's drop-oldest policy."""

import threading

import numpy as np
import pytest

from webradio_tpu.io import ring as jring
from webradio_tpu.io import source as jsrc
from webradio_tpu_torch.io import ring as tring
from webradio_tpu_torch.io import source as tsrc

CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-450_000.0, "CW", 0.0))


def _set(src, rate, frames):
    src.sample_rate, src.block_frames, src.realtime = rate, frames, False
    return src


@pytest.mark.parametrize("seed,carriers,noise", [
    (0, tsrc.ToneSource.DEFAULT_CARRIERS, 0.01),
    (5, CARRIERS, 0.5),
    (9, CARRIERS, 0.0),
])
def test_tone_source_bit_equal(seed, carriers, noise):
    a = _set(jsrc.ToneSource(carriers, noise, seed), 2_400_000, 51_200)
    b = _set(tsrc.ToneSource(carriers, noise, seed), 2_400_000, 51_200)
    for _ in range(3):  # phase-continuous across blocks
        x, y = a.read_block(), b.read_block()
        assert y.dtype == np.complex64 and y.shape == (51_200,)
        np.testing.assert_array_equal(x, y)
        assert np.abs(y).max() > 0.1
    assert tsrc.ToneSource.DEFAULT_CARRIERS == jsrc.ToneSource.DEFAULT_CARRIERS


def test_rand_source_bit_equal():
    a = _set(jsrc.RandSource(seed=3), 1_200_000, 4_096)
    b = _set(tsrc.RandSource(seed=3), 1_200_000, 4_096)
    for _ in range(2):
        np.testing.assert_array_equal(a.read_block(), b.read_block())
    assert b.sample_rate == 1_200_000 and b.subdevices == []


@pytest.mark.parametrize("ext", [".npy", ".cu8", ".cf32"])
def test_file_source_bit_equal_and_loops(tmp_path, ext):
    rng = np.random.default_rng(1)
    path = tmp_path / f"capture{ext}"
    if ext == ".npy":
        np.save(path, rng.standard_normal((1_000, 2)).astype(np.float32))
    elif ext == ".cu8":
        rng.integers(0, 256, 2_000, dtype=np.uint8).tofile(path)
    else:
        rng.standard_normal(2_000).astype(np.float32).tofile(path)
    a = _set(jsrc.FileSource(path), 1_200_000, 384)
    b = _set(tsrc.FileSource(path), 1_200_000, 384)
    for _ in range(4):  # 1,000 frames: the fourth block wraps around
        np.testing.assert_array_equal(a.read_block(), b.read_block())
    once = _set(tsrc.FileSource(path, loop=False), 1_200_000, 384)
    assert [once.read_block() is None for _ in range(3)] == [
        False, False, True]
    assert b.subdevice == str(path)
    assert b.start() and not b.set_subdevice("x")  # only while stopped
    b.stop()
    assert b.set_subdevice("x")


def test_block_ring_drops_oldest_like_the_reference():
    for mod in (jring, tring):
        ring = mod.BlockRing(depth=2)
        for i in range(5):
            ring.put(i)
        assert (ring.dropped_blocks, ring.total_blocks, ring.backlog) == (
            3, 5, 2)
        assert ring.drain(8) == [3, 4]
        assert ring.get(timeout=0.01) is None
        ring.close()
        assert ring.closed and ring.get() is None


def test_capture_thread_pumps_a_source_into_the_ring():
    class Tuner:
        def __init__(self):
            self.src = _set(tsrc.ToneSource(seed=2), 2_400_000, 1_024)
            self.left = 3

        def read_block(self):
            self.left -= 1
            return self.src.read_block() if self.left >= 0 else None

    ring = tring.BlockRing(depth=4)
    thread = tring.CaptureThread(Tuner(), ring)
    thread.start()
    thread.join(timeout=10)
    assert not thread.is_alive() and ring.closed
    want = _set(tsrc.ToneSource(seed=2), 2_400_000, 1_024)
    for _ in range(3):
        np.testing.assert_array_equal(ring.get(timeout=1), want.read_block())
    assert ring.get(timeout=0.01) is None
    assert isinstance(thread, threading.Thread)
