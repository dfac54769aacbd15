"""The port's soundcard layer (``webradio_tpu_torch.io.soundcard`` and the
``"soundcard"`` tuner driver): the twin of ``tests/test_soundcard.py``.

The build image has no sound stack, so every test runs against a stand-in
for libpulse-simple put in ``soundcard._PA``: the ctypes call contract, the
plane conversion, the read/close guard (``pa_simple_free`` never runs while
a read is inside the library), the tuner seam with its failure reason, and
the live app serving a soundcard tuner over HTTP on the CPU.
"""

import ctypes
import http.client
import threading
import time

import numpy as np
import pytest

from webradio_tpu_torch.io import soundcard
from webradio_tpu_torch.io.soundcard import PulseAudioSource, SoundcardIQSource
from webradio_tpu_torch.io.tuner import TUNER_DRIVERS, SoundcardTuner


class _Fn:
    """Stands in for a ctypes foreign function (restype and argtypes
    assignable)."""

    def __init__(self, impl):
        self._impl = impl
        self.restype = None

    def __call__(self, *args):
        return self._impl(*args)


class FakePulse:
    """Stand-in libpulse-simple: blocking reads yield a deterministic ramp
    (channel 0 = +n, channel 1 = -n), paced at ``rate`` frames a second
    when it is set, like a soundcard clock."""

    def __init__(self, rate=None):
        self.counter = 0
        self.freed = []
        self.new_calls = []
        self.rate = rate
        self.pa_simple_new = _Fn(self._new)
        self.pa_simple_read = _Fn(self._read)
        self.pa_simple_write = _Fn(lambda *a: 0)
        self.pa_simple_free = _Fn(lambda h: self.freed.append(h))

    def _new(self, server, name, direction, device, stream, spec, *rest):
        self.new_calls.append((name, direction, device, stream))
        return 0xBEEF

    def _read(self, handle, ptr, nbytes, err):
        n = nbytes // 4  # float32 count, interleaved stereo
        frames = n // 2
        ramp = np.arange(self.counter, self.counter + frames,
                         dtype=np.float32)
        inter = np.empty(n, np.float32)
        inter[0::2] = ramp
        inter[1::2] = -ramp
        ctypes.memmove(ptr, inter.ctypes.data, nbytes)
        self.counter += frames
        if self.rate:
            time.sleep(frames / self.rate)
        return 0


@pytest.fixture
def fake_pa(monkeypatch):
    fake = FakePulse()
    monkeypatch.setattr(soundcard, "_PA", fake)
    return fake


def test_pulse_source_read_contract(fake_pa):
    src = PulseAudioSource(48_000, 2, "alsa_input.line_in")
    # opened as a RECORD stream on the named device
    (name, direction, device, stream) = fake_pa.new_calls[0]
    assert direction == soundcard._PA_STREAM_RECORD
    assert device == b"alsa_input.line_in"
    data = src.read(16)
    assert data.shape == (32,)  # interleaved stereo
    np.testing.assert_array_equal(data[0::2], np.arange(16, dtype=np.float32))
    src.close()
    assert fake_pa.freed, "pa_simple_free never called"
    assert src.read(16) is None  # closed: no call reaches the library
    assert fake_pa.counter == 16


def test_iq_source_planes(fake_pa):
    src = SoundcardIQSource("line-in")
    src.sample_rate = 48_000
    src.block_frames = 64
    assert src.start()
    block = src.read_block()
    assert block.shape == (2, 64) and block.dtype == np.float32
    np.testing.assert_array_equal(block[0], np.arange(64, dtype=np.float32))
    np.testing.assert_array_equal(block[1], -np.arange(64, dtype=np.float32))
    # consecutive blocks continue the capture stream
    block2 = src.read_block()
    np.testing.assert_array_equal(block2[0][0], np.float32(64))
    src.stop()
    assert fake_pa.freed
    assert src.read_block() is None  # closed: clean end-of-stream


def test_unavailable_without_libpulse(monkeypatch):
    monkeypatch.setattr(soundcard, "_PA", None)
    assert not soundcard.pulse_available()
    src = SoundcardIQSource()
    assert src.start() is False  # graceful, like the hardware drivers
    assert "libpulse-simple not found" in src.error
    # the tuner fails its start with the reason, and serves nothing
    t = SoundcardTuner("line-in")
    assert t.start() is False
    assert "libpulse-simple" in t.error
    assert t.read_block() is None


def test_tuner_seam(fake_pa):
    assert TUNER_DRIVERS["soundcard"] is SoundcardTuner
    t = SoundcardTuner("line-in")
    assert t.driver == "soundcard"
    assert t.product == "PulseAudioSource"
    t.set_sample_rate(96_000)
    t.set_block_frames(128)
    assert t.start() and t.error is None
    b = t.read_block()
    assert b.shape == (2, 128)
    t.stop()
    assert fake_pa.freed


def test_stop_waits_for_a_read_inside_the_library(monkeypatch):
    """``stop`` from another thread while a read blocks in
    ``pa_simple_read``: the stream is freed only after that read has
    returned, and the reader then ends cleanly."""
    fake = FakePulse()
    entered, release = threading.Event(), threading.Event()
    read = fake._read

    def blocking_read(*args):
        entered.set()
        release.wait(10)
        return read(*args)

    fake.pa_simple_read = _Fn(blocking_read)
    monkeypatch.setattr(soundcard, "_PA", fake)
    src = SoundcardIQSource()
    src.block_frames = 32
    assert src.start()
    got = []
    reader = threading.Thread(target=lambda: got.append(src.read_block()))
    reader.start()
    assert entered.wait(10)
    stopper = threading.Thread(target=src.stop)
    stopper.start()
    stopper.join(0.2)
    assert stopper.is_alive() and not fake.freed  # waits for the read
    release.set()
    reader.join(10)
    stopper.join(10)
    assert not reader.is_alive() and not stopper.is_alive()
    assert got[0].shape == (2, 32) and len(fake.freed) == 1
    assert src.read_block() is None


def test_live_app_soundcard_tuner(monkeypatch):
    """Full seam: the topology names the soundcard driver; capture flows
    through the ingest ring and the port's pipeline (on the CPU) to an
    HTTP audio stream, paced by the stand-in's soundcard clock."""
    fake = FakePulse(rate=256_000)
    monkeypatch.setattr(soundcard, "_PA", fake)
    from webradio_tpu_torch.app import RadioApp
    from webradio_tpu_torch.radio import Radio
    from webradio_tpu_torch.web.audiostream import AudioStreamManager

    Radio.reset()
    AudioStreamManager.reset()
    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [{
            "driver": "soundcard", "subdevice": "line-in",
            "centre_frequency": 7_056_000,  # soft-rock style LO
            "sample_rate": 256_000, "channel_rate": 32_000,
            "audio_rate": 8_000, "block_frames": 8_192, "capacity": 2,
        }],
        "receivers": [
            {"tuner": 0, "if_frequency": 0, "demodulator": "USB"},
        ],
    }
    app = RadioApp(config, device="cpu")
    assert app.start()
    try:
        fe = app.front_ends[0]
        deadline = time.time() + 60
        while fe.block_count < 3 and time.time() < deadline:
            time.sleep(0.05)
        assert fe.block_count >= 3, "soundcard capture never pumped"

        conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                          timeout=60)
        conn.request("GET", f"/tuners/{fe.uuid}")
        resp = conn.getresponse()
        info = resp.read()
        conn.close()
        assert resp.status == 200
        assert b"soundcard" in info and b"PulseAudioSource" in info

        rx_uuid = next(iter(fe.receivers))
        conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                          timeout=60)
        conn.request("GET", f"/audio/{rx_uuid}.wav")
        resp = conn.getresponse()
        assert resp.status == 200
        assert len(resp.read(2048)) == 2048
        conn.close()
    finally:
        app.close()
        AudioStreamManager.reset()
        Radio.reset()
    assert fake.freed, "capture stream not freed on close"
