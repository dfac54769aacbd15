"""The port's HTTP surface (``webradio_tpu_torch.app`` / ``web``) on the CPU:
the port of ``tests/test_web.py`` on ``RadioApp(config, device="cpu")``.

Spins up the whole application (block pump + HTTP server on port 0) on the
tone tuner at reduced rates, then drives every route of the reference API
(src/main.cxx:92-106) plus the receiver lifecycle extension, hears the
tone tuner's carriers through the WAV stream (AM 1 kHz at IF 0, FM 440 Hz
at +100 kHz), and runs ``python -m webradio_tpu_torch`` in a subprocess.
Waits are on conditions ("block_count >= n") with generous timeouts; no
test asserts wall-clock pacing.
"""

import http.client
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from webradio_tpu_torch import app as tapp
from webradio_tpu_torch.radio import Radio
from webradio_tpu_torch.web import encoders
from webradio_tpu_torch.web.audiostream import AudioStreamManager
from webradio_tpu_torch.web.handlers import ConfigHandler
from webradio_tpu_torch.web.routes import UrlTree
from webradio_tpu_torch.web.server import RadioHttpServer

REPO = pathlib.Path(__file__).resolve().parent.parent
FS, AUDIO_RATE = 256_000, 8_000
WAIT_S = 120.0


def wait_for(cond, timeout=WAIT_S, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


# ---------------------------------------------------------------- routing
def _tree():
    t = UrlTree()
    t.register("", "root", None)
    t.register("static/**", "file", None)
    t.register("tuners", "tuners", None)
    t.register("tuners/*", "tuner", None)
    t.register("tuners/*/waterfall", "waterfall", None)
    t.register("audio/*", "audio", None)
    t.register("tuners/special", "special", None)
    return t


@pytest.mark.parametrize("path,want", [
    ("/tuners", ("tuners", [])),
    ("/", ("root", [])),
    ("/tuners/0000", ("tuner", ["0000"])),
    ("/tuners/abcd/waterfall", ("waterfall", ["abcd"])),
    ("/static/css/deep/file.css", ("file", ["css/deep/file.css"])),
    ("/tuners/special", ("special", [])),  # a literal beats a star
    ("/tuners/other", ("tuner", ["other"])),
    ("/audio/0001.wav", ("audio", ["0001.wav"])),
    ("/nope", None),
])
def test_url_tree(path, want):
    found = _tree().find(path)
    if want is None:
        assert found is None
    else:
        assert (found[0], found[2]) == want


def test_url_tree_rejects_inner_double_star():
    with pytest.raises(ValueError):
        UrlTree().register("a/**/b", "x")


# ---------------------------------------------------------------- live app
CONFIG = {
    "server": {"port": 0, "host": "127.0.0.1", "html": str(REPO / "html")},
    "tuners": [{
        "driver": "tone",
        "centre_frequency": 100_000_000,
        "sample_rate": FS,
        "channel_rate": 32_000,
        "audio_rate": AUDIO_RATE,
        "block_frames": 8_192,
        "capacity": 2,
    }],
    "receivers": [{"tuner": 0, "if_frequency": 0, "demodulator": "AM"}],
}


@pytest.fixture(scope="module")
def app():
    Radio.reset()
    AudioStreamManager.reset()
    a = tapp.RadioApp(json.loads(json.dumps(CONFIG)), device="cpu")
    assert a.start()
    # the first dispatch only primes the double buffer (a catch-up scan
    # of a backlog counts several blocks at once): wait for a published
    # spectrum row (-10000 everywhere until then)
    wait_for(lambda: a.front_ends[0].get_spectrum_db().max() > -10000.0,
             what="a published block")
    yield a
    a.close()
    AudioStreamManager.reset()


def request(app, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", app.server.port, timeout=30)
    headers = {"Content-Type": "application/json"} if body else {}
    if body is not None and not isinstance(body, bytes):
        body = json.dumps(body)
    conn.request(method, path, body=body, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    out = (resp.status, dict(resp.getheaders()), data)
    conn.close()
    return out


def stream(port, path, nbytes, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("GET", path)
    resp = conn.getresponse()
    status, ctype = resp.status, resp.getheader("Content-Type")
    data = b""
    while status == 200 and len(data) < nbytes:
        chunk = resp.read(4096)
        if not chunk:
            break
        data += chunk
    conn.close()
    return status, ctype, data


def dominant_hz(wav: bytes, rate: int, skip_s: float = 0.25) -> float:
    pcm = np.frombuffer(wav[44:44 + (len(wav) - 44) // 2 * 2], "<i2")
    x = pcm[int(skip_s * rate):].astype(np.float64)
    assert x.size > rate // 2 and np.abs(x).max() > 100, "silent audio"
    spec = np.abs(np.fft.rfft((x - x.mean()) * np.hanning(x.size)))
    return float(np.argmax(spec) * rate / x.size)


def test_config(app):
    status, headers, data = request(app, "GET", "/config")
    assert status == 200
    assert headers["Content-Type"] == "application/json"
    assert json.loads(data)["version"] == "1.0"  # confighandler.cxx:46
    assert headers["Access-Control-Allow-Origin"] == "*"


def test_redirects(app):
    uuid = app.front_ends[0].uuid
    rx = app.receivers[0].uuid
    for path, target in (
            ("/", "/static/ui.html"),
            (f"/tuners/{uuid}/receivers", f"/receivers?tuner_id={uuid}"),
            (f"/receivers/{rx}/audio.wav", f"/audio/{rx}.wav"),
            (f"/receivers/{rx}/audio.mp3", f"/audio/{rx}.mp3"),
            (f"/receivers/{rx}/audio.ogg", f"/audio/{rx}.ogg")):
        status, headers, _ = request(app, "GET", path)
        assert status == 302, path
        assert headers["Location"].endswith(target)
    # the .ogg target 404s (no Vorbis encoder), as in the reference
    assert request(app, "GET", f"/audio/{rx}.ogg")[0] == 404


def test_tuner_list_and_single(app):
    status, _, data = request(app, "GET", "/tuners")
    assert status == 200
    tuners = json.loads(data)
    assert len(tuners) == 1
    info = tuners[0]
    for key in ("uri", "name", "driver", "port", "serial_nr", "manufacturer",
                "product", "sample_rate", "iq", "control", "peaks",
                "receivers", "waterfall"):
        assert key in info, key
    assert info["iq"] == "true" and info["sample_rate"] == FS
    assert info["driver"] == "tone"
    status, _, data = request(app, "GET", info["uri"])
    assert status == 200 and json.loads(data) == info
    assert request(app, "GET", "/tuners/ffff")[0] == 404


def test_tuner_control_get_put(app):
    uuid = app.front_ends[0].uuid
    status, _, data = request(app, "GET", f"/tuners/{uuid}/control")
    assert status == 200
    assert set(json.loads(data)) == {"centre_frequency", "agc", "rf_gain",
                                     "if_gain", "offset"}
    status, _, _ = request(app, "PUT", f"/tuners/{uuid}/control",
                           {"centre_frequency": 101_000_000, "agc": False,
                            "rf_gain": 12, "offset": -3})
    assert status == 204
    ctl = json.loads(request(app, "GET", f"/tuners/{uuid}/control")[2])
    assert ctl == {"centre_frequency": 101_000_000, "agc": False,
                   "rf_gain": 12, "if_gain": 0, "offset": -3}
    request(app, "PUT", f"/tuners/{uuid}/control",
            {"centre_frequency": 100_000_000, "agc": True, "offset": 0})


def test_waterfall_and_peaks(app):
    uuid = app.front_ends[0].uuid
    status, _, data = request(app, "GET", f"/tuners/{uuid}/waterfall")
    assert status == 200
    root = json.loads(data)
    assert set(root) == {"centre_frequency", "sample_rate", "data"}
    spec = np.array(root["data"])
    n = app.front_ends[0].cfg.fft_size
    assert spec.shape == (n,) and np.isfinite(spec).all()
    assert spec.max() > -10000.0
    # the tone tuner's carriers: AM at the centre, FM at +100 kHz sweeping
    # +/-5 kHz (the AM envelope swings 0.5-1.5, so some rows peak there)
    peak = int(np.argmax(spec))
    fm_bin, fm_span = n // 2 + round(100_000 / FS * n), 1 + 5_000 * n // FS
    assert abs(peak - n // 2) <= 1 or abs(peak - fm_bin) <= fm_span, peak
    assert spec[n // 2] > np.median(spec) + 20.0
    status, _, data = request(app, "GET", f"/tuners/{uuid}/peaks?count=4")
    assert status == 200
    root = json.loads(data)
    assert 0 < len(root["peaks"]) <= 4
    centre = root["centre_frequency"]
    offsets = sorted(abs(p["frequency"] - centre) for p in root["peaks"][:2])
    assert offsets[0] < 1_000 and abs(offsets[1] - 100_000) < 7_000
    levels = [p["level_db"] for p in root["peaks"]]
    assert levels == sorted(levels, reverse=True)
    assert request(app, "GET", f"/tuners/{uuid}/peaks?count=x")[0] == 400


def test_receiver_get_put_and_validation(app):
    status, _, data = request(app, "GET", "/receivers")
    assert status == 200
    info = json.loads(data)[0]
    for key in ("uri", "tuner", "if_frequency", "if_bandwidth",
                "af_bandwidth", "af_gain", "squelch_threshold",
                "demodulator"):
        assert key in info, key
    uri = info["uri"]
    before = json.loads(request(app, "GET", uri)[2])
    # validate-then-apply: a PUT with one bad field changes nothing
    for bad in ({"if_frequency": 1_000, "demodulator": "CHIRP"},
                {"if_frequency": "many", "af_gain": 6},
                {"if_bandwidth": -5, "demodulator": "FM"}):
        assert request(app, "PUT", uri, bad)[0] == 400
        assert json.loads(request(app, "GET", uri)[2]) == before
    # squelch: a number gates, absent leaves it, JSON null disables
    assert request(app, "PUT", uri, {"squelch_threshold": 5})[0] == 204
    request(app, "PUT", uri, {"af_gain": 3})
    assert json.loads(request(app, "GET", uri)[2])["squelch_threshold"] == 5
    assert request(app, "PUT", uri, {"squelch_threshold": None})[0] == 204
    got = json.loads(request(app, "GET", uri)[2])
    assert got["squelch_threshold"] is None and got["af_gain"] == 3
    request(app, "PUT", uri, {"af_gain": 0})
    assert request(app, "PUT", "/receivers", {})[0] == 405
    assert request(app, "PUT", "/receivers/ffff", {})[0] == 404


def test_receiver_lifecycle_post_put_delete(app):
    uuid = app.front_ends[0].uuid
    fe = app.front_ends[0]
    status, headers, data = request(
        app, "POST", "/receivers",
        {"tuner": f"/tuners/{uuid}", "if_frequency": 25_000,
         "demodulator": "USB"})
    assert status == 201
    created = json.loads(data)
    assert created["demodulator"] == "USB"
    assert headers["Location"].endswith(created["uri"])
    _, _, data = request(app, "GET", f"/receivers?tuner_id={uuid}")
    assert created["uri"] in [r["uri"] for r in json.loads(data)]
    assert request(app, "PUT", created["uri"],
                   {"if_frequency": 30_000, "demodulator": "LSB"})[0] == 204
    rx_id = created["uri"].rsplit("/", 1)[1]
    slot = fe.slots_of(Radio.receivers[rx_id])[0]
    blocks = fe.block_count
    # the write applies before the next block the pump begins, within a
    # catch-up too; the block under way may still count, so wait past it
    # for one that began after the write
    wait_for(lambda: fe.block_count >= blocks + 2,
             what="a block served after the write")
    assert int(fe.pipeline.params.rx.mode[slot]) == 3  # LSB, applied
    assert request(app, "DELETE", created["uri"])[0] == 204
    assert request(app, "GET", created["uri"])[0] == 404
    assert request(app, "DELETE", created["uri"])[0] == 404
    assert request(app, "POST", "/receivers", {"tuner": "/tuners/zz",
                                               "demodulator": "XX"})[0] == 400


def test_405_and_404(app):
    status, headers, _ = request(app, "PUT", "/tuners")
    assert status == 405 and "GET" in headers["Allow"]
    assert request(app, "GET", "/definitely/not/registered")[0] == 404
    assert request(app, "GET", "/audio/ffff.wav")[0] == 404
    rx = app.receivers[0].uuid
    assert request(app, "GET", f"/audio/{rx}.xyz")[0] == 404


def test_audio_hears_the_tones(app):
    """AM at IF 0 hears the 1 kHz envelope; the same receiver moved to FM
    at +100 kHz hears 440 Hz."""
    rx = app.receivers[0]
    port = app.server.port
    nbytes = 44 + 2 * 2 * AUDIO_RATE  # two seconds of 16-bit mono
    status, ctype, wav = stream(port, f"/audio/{rx.uuid}.wav", nbytes)
    assert status == 200 and ctype == "audio/wav"
    assert wav[:4] == b"RIFF" and wav[8:12] == b"WAVE"
    assert abs(dominant_hz(wav, AUDIO_RATE) - 1_000.0) < 5.0
    assert request(app, "PUT", f"/receivers/{rx.uuid}",
                   {"if_frequency": 100_000, "demodulator": "FM"})[0] == 204
    fe = app.front_ends[0]
    blocks = fe.block_count
    wait_for(lambda: fe.block_count >= blocks + 3, what="retuned blocks")
    try:
        _, _, wav = stream(port, f"/audio/{rx.uuid}.wav", nbytes)
        assert abs(dominant_hz(wav, AUDIO_RATE) - 440.0) < 5.0
    finally:
        request(app, "PUT", f"/receivers/{rx.uuid}",
                {"if_frequency": 0, "demodulator": "AM"})


def test_audio_mp3_where_lame_loads(app):
    rx = app.receivers[0]
    status, ctype, data = stream(app.server.port, f"/audio/{rx.uuid}.mp3",
                                 4096)
    if not encoders.lame_available():
        assert status == 404  # audiostream.cxx:151-158
        return
    assert status == 200 and ctype == "audio/mpeg"
    assert len(data) >= 4096 and data.count(b"\xff") > 4


def test_static_files(app):
    status, headers, data = request(app, "GET", "/static/ui.html")
    assert status == 200 and headers["Content-Type"] == "text/html"
    assert b"webradio-tpu" in data
    status, headers, _ = request(app, "GET", "/static/waterfall.js")
    assert status == 200 and headers["Content-Type"] == "text/javascript"
    assert request(app, "GET", "/static/no-such-file.html")[0] == 404
    assert request(app, "GET", "/static/../SURVEY.md")[0] == 404


def test_status(app):
    fe = app.front_ends[0]
    wait_for(lambda: fe.step_samples >= 1, what="a profile sample")
    status, _, data = request(app, "GET", "/status")
    assert status == 200
    root = json.loads(data)
    assert set(root) >= {"front_ends", "receivers", "streams"}
    st = root["front_ends"][fe.uuid]
    assert st["running"] is True and st["blocks"] > 0
    assert st["ns_per_frame"] > 0 and st["last_step_ms"] > 0
    assert st["realtime_factor"] is not None and st["step_samples"] >= 1
    assert st["engine"] == "direct" and st["sample_rate"] == FS
    assert st["channel_capacity"] == 2
    assert "last_dispatch_ms" in st and "fanout_dropped" in st
    assert st["graph"]["plain_tail"] is None  # the CPU: the JAX rule
    assert root["receivers"][app.receivers[0].uuid]["demodulator"] == "AM"


def test_profile_endpoint_writes_a_trace(app, tmp_path):
    assert json.loads(request(app, "GET", "/profile")[2])["tracing"] is False
    trace_dir = str(tmp_path / "trace")
    status, _, data = request(app, "POST", "/profile",
                              {"action": "start", "dir": trace_dir})
    assert status == 200
    assert json.loads(data) == {"tracing": True, "trace_dir": trace_dir}
    assert request(app, "POST", "/profile", {"action": "start"})[0] == 400
    got = json.loads(request(app, "GET", "/profile")[2])
    assert got == {"tracing": True, "trace_dir": trace_dir}
    fe = app.front_ends[0]
    blocks = fe.block_count
    wait_for(lambda: fe.block_count >= blocks + 2, what="traced blocks")
    status, _, data = request(app, "POST", "/profile", {"action": "stop"})
    assert status == 200
    got = json.loads(data)
    assert (got["tracing"], got["trace_dir"]) == (False, trace_dir)
    # what the profiler's start, stop and export and the waits for the
    # pump after the stop and the export took; kernel events are counted
    # (and the check timed) on the card only
    assert set(got["timings_ms"]) == {"start", "stop", "wait_after_stop",
                                      "export", "wait_after_export"}
    assert all(v >= 0 for v in got["timings_ms"].values())
    assert got["kernel_events"] is None
    trace = json.loads((pathlib.Path(trace_dir) / "trace.json").read_text())
    assert "traceEvents" in trace
    # the flight recorder's spans of the traced blocks, on the host's
    # tracks beside the profiler's events
    host = [e for e in trace["traceEvents"] if e.get("cat") == "webradio_host"]
    assert {"put", "dispatch", "publish"} <= {e["name"] for e in host}
    assert request(app, "POST", "/profile", {"action": "stop"})[0] == 400
    assert request(app, "POST", "/profile", b"{bad json")[0] == 400


def test_a_card_trace_without_kernels_is_refused(tmp_path):
    """A card's trace with copies but no kernel while the pump served
    blocks is a profiler fault: it is kept aside and refused, so /profile
    answers with the reason instead of an empty trace.json."""
    from webradio_tpu_torch.web import handlers

    trace = tmp_path / "trace.json"
    copies = [{"cat": "gpu_memcpy", "name": "Memcpy HtoD"}] * 3
    trace.write_text(json.dumps({"traceEvents": copies}))
    with pytest.raises(RuntimeError, match="3 copy events but no kernel"):
        handlers.check_trace_has_kernels(trace, served=7)
    assert not trace.exists()
    assert (tmp_path / "trace_without_kernels.json").exists()
    # no block served: an idle card's empty trace is a reading
    trace.write_text(json.dumps({"traceEvents": copies}))
    assert handlers.check_trace_has_kernels(trace, served=0) == 0
    trace.write_text(json.dumps({"traceEvents": copies + [
        {"cat": "kernel", "name": "tail_tm_kernel"}] * 2}))
    assert handlers.check_trace_has_kernels(trace, served=7) == 2


def test_checkpoint_roundtrip(app, tmp_path):
    app.state_file = tmp_path / "state.json"
    try:
        app.front_ends[0].tuner.set_centre_frequency(102_500_000)
        rx = app.receivers[0]
        rx.update(if_frequency=42_000, demodulator="USB", af_gain=7,
                  squelch_threshold=-42.5)
        app.checkpoint_if_changed()
        saved = json.loads(app.state_file.read_text())
        merged = tapp._merge_state(app.config, saved)
        assert merged["tuners"][0]["centre_frequency"] == 102_500_000
        got = [r for r in merged["receivers"] if r["if_frequency"] == 42_000]
        assert got and got[0]["demodulator"] == "USB"
        assert got[0]["af_gain"] == 7 and got[0]["squelch_threshold"] == -42.5
        assert merged["tuners"][0]["capacity"] == len(app.front_ends[0]._slots)
        rx.update(squelch_threshold=None)
        app.checkpoint_if_changed()
        merged = tapp._merge_state(app.config,
                                   json.loads(app.state_file.read_text()))
        got = [r for r in merged["receivers"] if r["if_frequency"] == 42_000]
        assert got[0]["squelch_threshold"] is None
    finally:
        app.state_file = None
        app.front_ends[0].tuner.set_centre_frequency(100_000_000)
        app.receivers[0].update(if_frequency=0, demodulator="AM", af_gain=0)


def test_merge_state_matches_jax():
    from webradio_tpu import app as japp

    saved = {
        "tuners": [{"centre_frequency": 98_700_000, "agc": False,
                    "rf_gain": 20, "offset_ppm": -1, "capacity": 64}],
        "receivers": [
            {"tuner": 0, "if_frequency": 123_000, "if_bandwidth": 40_000,
             "af_bandwidth": 4_000, "demodulator": "FM"},
            {"tuner": 0, "if_frequency": -50_000, "demodulator": "LSB",
             "squelch_threshold": -20.0},
        ],
    }
    assert tapp.DEFAULT_CONFIG == japp.DEFAULT_CONFIG
    assert tapp.load_config(None) == japp.load_config(None)
    assert (tapp._merge_state(tapp.DEFAULT_CONFIG, saved)
            == japp._merge_state(japp.DEFAULT_CONFIG, saved))


def test_state_file_restores_on_start(tmp_path):
    state = tmp_path / "state.json"
    state.write_text(json.dumps({"receivers": [
        {"tuner": 0, "if_frequency": 100_000, "demodulator": "FM"}]}))
    a = tapp.RadioApp(json.loads(json.dumps(CONFIG)), state_file=state,
                      device="cpu")
    try:
        a.build()
        assert [(r.if_frequency, r.demodulator) for r in a.receivers] == [
            (100_000, "FM")]
    finally:
        a.close()
    (tmp_path / "bad.json").write_text("{not json")
    a = tapp.RadioApp(json.loads(json.dumps(CONFIG)),
                      state_file=tmp_path / "bad.json", device="cpu")
    assert a.config["receivers"] == CONFIG["receivers"]  # config wins
    a.close()


def test_app_refuses_what_is_not_ported(monkeypatch):
    """Without a card the app raises unless the CPU is named; a
    ``"distributed": true`` topology builds, and without torchrun's
    environment it brings up no process group (one process serves)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tapp.RadioApp(json.loads(json.dumps(CONFIG)))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    config = json.loads(json.dumps(CONFIG))
    config.update(distributed=True)
    a = tapp.RadioApp(config, device="cpu")
    try:
        a.build()
        assert a.distributed is False and a._is_http_process()
        assert len(a.front_ends) == len(CONFIG["tuners"])
    finally:
        a.close()


def test_a_failed_block_stops_the_pump(monkeypatch):
    """No fallback: a block that raises stops the server's pump, and the
    error is kept; the pump does not go on to the next block."""
    a = tapp.RadioApp(json.loads(json.dumps(CONFIG)), device="cpu")
    try:
        assert a.start()
        fe = a.front_ends[0]
        wait_for(lambda: fe.block_count > 0, what="a first block")

        def broken(iq_planes):
            raise RuntimeError("CUDA error: an illegal memory access")

        # a block goes through process_host, or through process_host_many
        # when a backlog built up (a loaded host)
        monkeypatch.setattr(fe.pipeline, "process_host", broken)
        monkeypatch.setattr(fe.pipeline, "process_host_many", broken)
        wait_for(lambda: a.failed is not None, what="the pump to stop")
        assert "illegal memory access" in str(a.failed)
        assert a._stop.is_set()
        blocks = fe.block_count
        time.sleep(0.3)
        assert fe.block_count == blocks
    finally:
        a.close()


def test_a_failed_growth_build_stops_the_pump(monkeypatch):
    """No fallback across growth: when the wider pipeline fails to build
    or warm (a kernel that does not build or launch), the pump stops at its
    next block instead of serving the narrower pipeline, which would leave
    the new receivers silent."""
    from webradio_tpu_torch.pipeline.frontend import HostPipeline
    from webradio_tpu_torch.radio import Receiver

    a = tapp.RadioApp(json.loads(json.dumps(CONFIG)), device="cpu")
    try:
        assert a.start()
        fe = a.front_ends[0]
        wait_for(lambda: fe.block_count > 0, what="a first block")

        def broken(self, iq_planes):
            raise RuntimeError("CUDA error: no kernel image is available")

        # only the growth build warms a pipeline once the app is serving
        monkeypatch.setattr(HostPipeline, "process_host_sync", broken)
        for _ in range(2):  # the third receiver grows capacity 2 -> 4
            Receiver().set_front_end(fe)
        assert fe.cfg.num_channels == 4
        wait_for(lambda: a.failed is not None, what="the pump to stop")
        assert "growth build failed" in str(a.failed)
        assert "no kernel image" in str(a.failed.__cause__)
        assert a._stop.is_set() and fe.pipeline.cfg.num_channels == 2
        blocks = fe.block_count
        time.sleep(0.3)
        assert fe.block_count == blocks
    finally:
        a.close()


def test_the_pump_drains_one_front_end_while_another_waits():
    """One pump thread serves every front end. A backlog in one ring (two
    blocks put into it) drains although the other front end's ring is empty
    most of the time: the pump never waits on one front end's next block
    while another's blocks are ready."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg["tuners"].append(dict(cfg["tuners"][0]))
    a = tapp.RadioApp(cfg, device="cpu")
    try:
        assert a.start()
        fe0, fe1 = a.front_ends
        wait_for(lambda: min(fe0.block_count, fe1.block_count) > 3,
                 what="blocks on both front ends")
        quiet = np.zeros((2, fe1.cfg.block_frames), np.float32)
        for _ in range(2):
            fe1.ring.put(quiet)
        wait_for(lambda: fe1.ring.backlog == 0, timeout=10.0,
                 what="the second ring to drain")
        assert a.failed is None
    finally:
        a.close()


def test_connection_limit():
    """Connections above the cap are refused (httpserver.h:42)."""
    srv = RadioHttpServer(port=0, host="127.0.0.1", max_connections=2)
    srv.register_handler("config", ConfigHandler)
    assert srv.start()
    socks = []
    try:
        for _ in range(2):
            c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
            c.request("GET", "/config")
            c.getresponse().read()
            socks.append(c)
        time.sleep(0.2)
        extra = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        extra.sendall(b"GET /config HTTP/1.1\r\nHost: x\r\n\r\n")
        extra.settimeout(5)
        assert extra.recv(1024) == b""
        extra.close()
        socks.pop().close()
        time.sleep(0.3)
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
        c.request("GET", "/config")
        assert c.getresponse().status == 200
        c.close()
    finally:
        for c in socks:
            c.close()
        srv.stop()


def test_missing_host_header_rejected(app):
    s = socket.create_connection(("127.0.0.1", app.server.port), timeout=10)
    s.sendall(b"GET /config HTTP/1.0\r\n\r\n")
    data = s.recv(200)
    s.close()
    assert b"400" in data.split(b"\r\n")[0]


# ---------------------------------------------------------------- process
_RUN_MAIN = """
import runpy, sys
try:
    runpy.run_module("webradio_tpu_torch", run_name="__main__")
finally:
    print("FOREIGN", sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "webradio_tpu")),
          file=sys.stderr, flush=True)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_python_m_serves_on_the_cpu_and_exits_on_sigint(tmp_path):
    args = ["--platform", "cpu", "-c", "examples/demo_tone.json", "-p", "0"]
    log = open(tmp_path / "server.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", _RUN_MAIN, *args], cwd=REPO, env=_env(),
        stdout=log, stderr=subprocess.STDOUT, text=True)
    try:
        port = None

        def up():
            nonlocal port
            assert proc.poll() is None, (tmp_path / "server.log").read_text()
            for line in (tmp_path / "server.log").read_text().splitlines():
                if "up on port" in line:
                    port = int(line.split("up on port")[1].split()[0])
            return port is not None

        wait_for(up, what="the server to come up")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/tuners")
        resp = conn.getresponse()
        tuners = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and tuners[0]["sample_rate"] == 2_400_000
        status, ctype, wav = stream(port, "/audio/0000.wav", 44 + 9_600)
        assert status == 200 and ctype == "audio/wav"
        assert wav[:4] == b"RIFF" and len(wav) >= 44 + 9_600
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp_path / "server.log").read_text()
    assert "FOREIGN []" in text, text[-2000:]


def test_python_m_without_a_card_exits_with_the_error():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-m", "webradio_tpu_torch", "-c",
         "examples/demo_tone.json", "-p", "0"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "needs a CUDA device" in out.stderr
