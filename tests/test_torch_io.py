"""The port's own host I/O (``webradio_tpu_torch.io``) against the JAX
package's ``webradio_tpu.io``: the same seed gives bit-equal blocks, the
ring keeps the reference's drop-oldest policy, the tuner drivers behave as
the JAX package's (rtl_tcp against a fake server, both capture paths), and
the port's native ingest library builds atomically in its own build
directory and frees no session under a waiting reader."""

import threading
import time

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


# ---------------------------------------------------------------- tuners
def test_tuner_drivers_match_jax():
    from webradio_tpu.io import tuner as jtuner
    from webradio_tpu_torch.io import tuner as ttuner

    assert set(ttuner.TUNER_DRIVERS) == set(jtuner.TUNER_DRIVERS) | {
        "rtlsdr"}
    # the soundcard driver builds without libpulse-simple (it opens at
    # start())
    assert ttuner.TUNER_DRIVERS["soundcard"] is ttuner.SoundcardTuner
    assert ttuner.TUNER_DRIVERS["soundcard"]("").type == "soundcard"
    # the librtlsdr driver builds without a dongle (it opens at start())
    assert ttuner.TUNER_DRIVERS["rtlsdr"]("").type == "rtlsdr"
    assert ttuner.TUNER_DRIVERS["rand"]().type == "rand"
    for hz in (225_000, 250_000, 1_024_000, 2_400_000, 3_200_001):
        assert (ttuner.rtl_effective_sample_rate(hz, 28_801_000)
                == jtuner.rtl_effective_sample_rate(hz, 28_801_000))
    assert ttuner.RTL_GAIN_TABLES == jtuner.RTL_GAIN_TABLES


def test_file_tuner_reads_the_capture(tmp_path):
    from webradio_tpu_torch.io import tuner as ttuner

    path = tmp_path / "c.cu8"
    np.random.default_rng(2).integers(0, 256, 4_000, np.uint8).tofile(path)
    t = ttuner.TUNER_DRIVERS["file"](str(path))
    t.set_sample_rate(1_024_000)
    t.set_block_frames(512)
    t.source.realtime = False
    want = _set(tsrc.FileSource(path), 1_024_000, 512)
    assert t.start() and t.serial == str(path)
    np.testing.assert_array_equal(t.read_block(), want.read_block())
    t.set_centre_frequency(99_000_000)
    t.set_agc(False)
    t.set_gain_db(7.5)
    assert (t.centre_frequency, t.agc, t.gain_db) == (99_000_000, False, 7.5)
    t.stop()


@pytest.mark.parametrize("python_tone", [False, True])
def test_tone_tuner_prefers_the_native_source(monkeypatch, python_tone):
    from webradio_tpu_torch.io import native
    from webradio_tpu_torch.io import tuner as ttuner

    if python_tone:
        monkeypatch.setenv("WEBRADIO_PYTHON_TONE", "1")
    else:
        monkeypatch.delenv("WEBRADIO_PYTHON_TONE", raising=False)
    t = ttuner.ToneTuner()
    native_src = native.available() and not python_tone
    assert isinstance(t.source, tsrc.NativeToneSource if native_src
                      else tsrc.ToneSource)
    assert t.type == "tone" and t.product == "ToneSource"


class _FakeRtlTcp:
    """A fake rtl_tcp server: the 12-byte header, then u8 samples; it
    records the 5-byte commands it receives."""

    def __init__(self, tuner_type=5, gain_count=29):
        import socket

        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.commands = []
        self._stop = False
        self._hdr = b"RTL0" + tuner_type.to_bytes(4, "big") + \
            gain_count.to_bytes(4, "big")
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        import struct

        conn, _ = self.sock.accept()
        conn.sendall(self._hdr)
        conn.settimeout(0.05)
        data = bytes(range(256)) * 16
        while not self._stop:
            try:
                try:
                    cmd = conn.recv(5)
                    while len(cmd) >= 5:
                        self.commands.append(struct.unpack(">BI", cmd[:5]))
                        cmd = cmd[5:]
                except TimeoutError:
                    pass
                conn.sendall(data)
            except OSError:
                break
        conn.close()

    def close(self):
        self._stop = True
        self.sock.close()


@pytest.mark.parametrize("use_native", [False, True])
def test_rtltcp_tuner_against_a_fake_server(monkeypatch, use_native):
    from webradio_tpu_torch.io import native
    from webradio_tpu_torch.io import tuner as ttuner

    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert native.available()
    srv = _FakeRtlTcp(tuner_type=5, gain_count=29)
    try:
        t = ttuner.RtlTcpTuner(f"127.0.0.1:{srv.port}")
        t.set_sample_rate(1_024_000)
        t.set_block_frames(2_048)
        assert t.start()
        assert (t.tuner_type, t.tuner_gain_count) == ("R820T", 29)
        assert t.product == "rtl_tcp (R820T)"
        t.set_agc(False)
        t.set_gain_db(25)  # R820T has no 25.0 dB step: 25.4
        assert t.gain_db == pytest.approx(25.4)
        block = t.read_block()
        assert block is not None
        planes = block if block.ndim == 2 else np.stack(
            [block.real, block.imag])
        assert planes.shape == (2, 2_048)
        u8 = np.frombuffer(bytes(range(256)) * 16, np.uint8)
        vals = (u8.astype(np.float32) - 128) / 128
        assert np.isin(planes, vals).all()
        deadline = time.monotonic() + 30
        while (0x04, 254) not in srv.commands and time.monotonic() < deadline:
            time.sleep(0.05)
        assert (0x04, 254) in srv.commands
        assert (0x02, 1_024_000) in srv.commands
        t.stop()
    finally:
        srv.close()


# ---------------------------------------------------------------- native
def test_native_conversions_and_ring():
    from webradio_tpu_torch.io import native

    assert native.available()
    raw = np.arange(256, dtype=np.uint8).repeat(2)[:512]
    planes = native.convert_u8_iq(raw)
    np.testing.assert_array_equal(
        planes[0], (raw[0::2].astype(np.float32) - 128) / 128)
    np.testing.assert_array_equal(
        planes[1], (raw[1::2].astype(np.float32) - 128) / 128)
    z = (np.random.default_rng(0).standard_normal(128)
         + 1j * np.random.default_rng(1).standard_normal(128)).astype(
             np.complex64)
    out = native.convert_planes(z)
    np.testing.assert_array_equal(out[0], z.real)
    np.testing.assert_array_equal(out[1], z.imag)
    ring = native.NativeRing(frames=8, depth=2)
    for i in range(4):
        ring.push(np.full((2, 8), i, np.float32))
    assert (ring.dropped_blocks, ring.total_blocks) == (2, 4)
    assert ring.pop(timeout=0.1)[0, 0] == 2
    assert ring.pop(timeout=0.1)[0, 0] == 3
    assert ring.pop(timeout=0.05) is None
    ring.close()


def test_a_failed_native_build_is_not_retried(monkeypatch):
    from webradio_tpu_torch.io import native

    calls = []
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    monkeypatch.setattr(native, "build", lambda: calls.append(1))
    assert not native.available() and not native.available()
    assert calls == [1]


def test_native_build_flags_take_the_source_as_it_is():
    from webradio_tpu_torch.io import native

    assert native.SOURCE.is_file() and native.SOURCE.parent.name == "src"
    assert "-march=native" not in native.CXX_FLAGS
    assert native.CXX_FLAGS[-2:] == ("-include", "cstdio")
    assert native.library_path().parent == native.BUILD_DIR


def test_native_tone_source_carries_the_tones():
    src = _set(tsrc.NativeToneSource(seed=1), 2_400_000, 24_000)
    assert src.start()
    try:
        block = src.read_block()
    finally:
        src.stop()
    assert block.shape == (2, 24_000) and block.dtype == np.float32
    z = block[0] + 1j * block[1]
    spec = np.abs(np.fft.fftshift(np.fft.fft(z)))
    hz = (np.argsort(spec)[::-1][:40] - 12_000) * 100.0  # 100 Hz bins
    assert (np.abs(hz) < 2_000).any()  # the AM carrier at the centre
    assert (np.abs(hz - 100_000) < 8_000).any()  # the FM one at +100 kHz
    assert src.read_block() is None  # stopped


def test_native_tone_source_stopped_while_a_reader_waits():
    """stop() from another thread while read_block waits in the native pop
    (one paced block takes 2 s here): the reader returns None and nothing
    frees the session under it (the JAX package's source.py:200 race)."""
    for _ in range(3):
        src = _set(tsrc.NativeToneSource(seed=3), 100_000, 200_000)
        src.realtime = True
        assert src.start()
        got = []
        reader = threading.Thread(target=lambda: got.append(
            src.read_block()))
        session = src._session
        free = session._close_fn
        inside = []  # readers inside the native pop when it is freed

        def close_fn(h):
            inside.append(session._readers)
            free(h)

        session._close_fn = close_fn
        reader.start()
        time.sleep(0.15)  # the reader is inside the native pop
        t0 = time.monotonic()
        src.stop()
        reader.join(timeout=30)
        assert inside == [0]
        assert not reader.is_alive() and got == [None]
        assert time.monotonic() - t0 < 5.0
        assert src._session is None and src.read_block() is None


class _SlowLib:
    """The native library with one entry point held up inside the call, so
    a ``close`` from another thread lands while a caller is inside it."""

    def __init__(self, lib, name, entered):
        self._lib, self._name, self._entered = lib, name, entered
        self.inside = 0  # callers inside the held-up entry point

    def __getattr__(self, attr):
        fn = getattr(self._lib, attr)
        if attr != self._name:
            return fn

        def slow(*args):
            self.inside += 1
            self._entered.set()
            try:
                time.sleep(0.3)
                return fn(*args)
            finally:
                self.inside -= 1

        return slow


@pytest.mark.parametrize("call,entry,closed", [
    (lambda s: s.command(s.CMD_FREQ, 100_000_000), "wr_rtltcp_command",
     False),
    (lambda s: s.dongle_info(), "wr_rtltcp_dongle_info", (0, 0)),
    (lambda s: s.dropped_blocks, "wr_rtltcp_dropped", 0),
])
def test_rtltcp_session_closed_while_a_control_call_runs(call, entry, closed):
    """close() from another thread while a control write (or a counter
    read) is inside the native call: the session is freed only after the
    call has left it, and a call after close touches no native object."""
    from webradio_tpu_torch.io import native

    assert native.available()
    srv = _FakeRtlTcp(tuner_type=5, gain_count=29)
    try:
        session = native.NativeRtlTcp("127.0.0.1", srv.port, 2_048)
        entered = threading.Event()
        lib = session._lib = _SlowLib(session._lib, entry, entered)
        free = session._close_fn
        inside = []  # callers inside a native call when the handle is freed

        def close_fn(h):
            inside.append(lib.inside)
            free(h)

        session._close_fn = close_fn
        got = []
        caller = threading.Thread(target=lambda: got.append(call(session)))
        caller.start()
        assert entered.wait(10)
        session.close()
        caller.join(timeout=10)
        assert inside == [0] and not caller.is_alive() and len(got) == 1
        assert session._h is None and call(session) == closed
    finally:
        srv.close()


_BUILD = """
import ctypes, sys
sys.path.insert(0, sys.argv[1])
from webradio_tpu_torch.io import native
path = native.build(build_dir=sys.argv[2])
lib = native._bind(ctypes.CDLL(str(path)))
out = native.np.empty((2, 4), native.np.float32)
lib.wr_convert_u8_iq(native.np.full(8, 192, native.np.uint8).ctypes.data_as(
    ctypes.POINTER(ctypes.c_uint8)), native._f32p(out[0]),
    native._f32p(out[1]), 4)
print(path.name, out[0, 0])
"""


def test_two_processes_build_the_native_library_at_once(tmp_path):
    """Both load the library, which was built once, atomically, in the
    port's own build directory (never into native/)."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(repo),
                               str(build_dir)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.split()[0] for out, _ in outs}
    assert len(names) == 1
    assert all(out.split()[1] == "0.5" for out, _ in outs)
    files = sorted(f.name for f in build_dir.iterdir())
    assert files == [".ingest.lock", names.pop()]  # no partial leftovers
