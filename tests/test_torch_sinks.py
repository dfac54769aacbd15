"""A receiver's local audio sink on the port's ``RadioApp`` (the
topology's ``audio_sink``: ``"file:<path>"`` and ``"pulse"``), driven
block by block through ``FrontEnd.run_once`` on the CPU (the test puts
each block into the ring; no pump thread, no deadline), through the real
fan-out worker and the sink's writer thread; and the binding's round trip
through the checkpoint. The port's twin of
``test_app_topologies.py::test_receiver_audio_sink_file_route``.
"""

import json
import time

import numpy as np

from webradio_tpu_torch import app as tapp
from webradio_tpu_torch import radio as tradio
from webradio_tpu_torch.io import soundcard
from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.radio import Radio, SinkWriter
from webradio_tpu_torch.web.audiostream import AudioStreamManager

AUDIO_RATE = 8_000
BLOCKS = 40  # 1.28 s of signal, 256 audio frames a block


def _config(sinks):
    return {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [{"driver": "tone", "sample_rate": 256_000,
                    "channel_rate": 32_000, "audio_rate": AUDIO_RATE,
                    "block_frames": 8_192, "capacity": 2}],
        "receivers": [{"tuner": 0, "if_frequency": 0, "demodulator": "AM",
                       "audio_sink": s} for s in sinks],
    }


class _NoCapture:
    """Stands in for the capture thread: the test puts the blocks into the
    ring itself, one at a time, so the audio is contiguous whatever the
    machine's load."""

    def __init__(self, tuner, ring):
        pass

    def start(self):
        pass

    def stop(self):
        pass

    def join(self, timeout=None):
        pass


def _until(cond, what):
    """Wait for ``cond()``; no deadline is asserted beyond a generous bound
    against a hang."""
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < 120, what
        time.sleep(0.001)


def test_receiver_audio_sink_file_route(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(soundcard, "_PA", None)  # no sound stack here
    monkeypatch.setattr(tradio, "CaptureThread", _NoCapture)
    Radio.reset()
    AudioStreamManager.reset()
    wav_path = tmp_path / "local_audio.wav"
    cfg = _config([f"file:{wav_path}", "pulse"])
    a = tapp.RadioApp(cfg, device="cpu")
    src = ToneSource(seed=5)
    src.sample_rate, src.block_frames, src.realtime = 256_000, 8_192, False
    try:
        with caplog.at_level("WARNING", logger="webradio_tpu_torch.app"):
            a.build()
        rx_file, rx_pulse = a.receivers
        writer = rx_file.audio_sink
        assert isinstance(writer, SinkWriter)
        assert isinstance(writer.sink, soundcard.FileAudioSink)
        # a pulse binding never breaks start-up on a server image
        assert rx_pulse.audio_sink is None
        assert "libpulse-simple not available" in caplog.text
        fe = a.front_ends[0]
        assert fe.start()
        for i in range(BLOCKS):
            fe.ring.put(src.read_block())
            assert fe.run_once(timeout=30)
            # the pipeline hands back the block before: once the fan-out
            # worker and the sink's writer have passed it on, the file
            # holds i blocks of 256 audio frames
            _until(lambda: writer.sink._frames == i * 256,
                   f"block {i} through the fan-out and the writer")
    finally:
        a.close()
        Radio.reset()
        AudioStreamManager.reset()
    writer._thread.join(30)  # the writer drains, then closes the file
    assert not writer._thread.is_alive()
    assert writer.dropped == 0 and fe.fanout_dropped == 0
    # the serving pipeline publishes one block behind: BLOCKS - 1 blocks of
    # 8 kHz audio in the file, its lengths patched at close
    data = wav_path.read_bytes()
    frames = (BLOCKS - 1) * 256
    assert len(data) == 44 + 2 * frames
    assert int.from_bytes(data[4:8], "little") == 36 + 2 * frames
    assert int.from_bytes(data[40:44], "little") == 2 * frames
    pcm = np.frombuffer(data[44:], "<i2").astype(np.float32) / 32768
    assert np.abs(pcm).max() > 0.05
    x = pcm[AUDIO_RATE // 4:]  # past the filters' start
    x = x - x.mean()
    f = np.fft.rfftfreq(len(x), 1 / AUDIO_RATE)
    peak = f[np.argmax(np.abs(np.fft.rfft(x * np.hanning(len(x)))))]
    assert abs(peak - 1_000) < 2, f"expected 1 kHz, got {peak:.1f} Hz"


def test_audio_sink_round_trips_through_the_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setattr(soundcard, "_PA", None)
    state = tmp_path / "state.json"
    sinks = [f"file:{tmp_path / 'a.wav'}", "pulse:alsa_output.speakers"]
    a = tapp.RadioApp(_config(sinks), state_file=state, device="cpu")
    try:
        a.build()
        a.checkpoint_if_changed()
        saved = json.loads(state.read_text())
        assert [r["audio_sink"] for r in saved["receivers"]] == sinks
    finally:
        a.close()
        Radio.reset()
    # a restart from the checkpoint binds the same sinks (the receiver list
    # comes from the checkpoint, which the merge takes wholesale)
    b = tapp.RadioApp(_config([None, None]), state_file=state, device="cpu")
    try:
        b.build()
        assert [rx.audio_sink_spec for rx in b.receivers] == sinks
        assert isinstance(b.receivers[0].audio_sink, SinkWriter)
        assert b.receivers[1].audio_sink is None  # no libpulse here
    finally:
        b.close()
        Radio.reset()
    # a receiver without a sink checkpoints None
    c = tapp.RadioApp(_config([None]), device="cpu")
    try:
        c.build()
        assert c.snapshot()["receivers"][0]["audio_sink"] is None
    finally:
        c.close()
        Radio.reset()


def test_a_sink_that_does_not_open_is_a_warning(tmp_path, caplog):
    cfg = _config([f"file:{tmp_path / 'no' / 'such' / 'dir.wav'}",
                   "speaker", "file:"])
    a = tapp.RadioApp(cfg, device="cpu")
    try:
        with caplog.at_level("WARNING", logger="webradio_tpu_torch.app"):
            a.build()
        assert all(rx.audio_sink is None for rx in a.receivers)
        assert "failed to open" in caplog.text
        assert "unknown audio_sink 'speaker'" in caplog.text
    finally:
        a.close()
        Radio.reset()
