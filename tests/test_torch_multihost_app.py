"""Multihost LIVE serving on the port (the twin of
``tests/test_multihost_app.py``).

1. One process, no process group: the full ``RadioApp`` runs the lockstep
   pump (``radio.FrontEnd._run_once_multihost``) with identity
   collectives, on a (time=2, chan=4) mesh of the CPU (``visible_devices``
   replaced in-process, as JAX's tests force 8 virtual devices): status,
   waterfall, audio over HTTP, a control write, and 409 past capacity.
2. Two real processes on gloo drive the live app
   (``tests/torch_multiproc_app_worker.py``): blocks flow on both, rank 0
   hears its receiver over HTTP, and a PUT on rank 0 reaches rank 1's
   parameters through the control broadcast.
3. A burst of control writes at 4,096 slots: the round's blob is longer
   than one broadcast buffer, goes in several, and applies as one
   per-shard slot scatter (the JAX pump's one-buffer blob raises past
   ~1,800 slots).

The waits below are generous deadlines for blocks to arrive, never a bound
on speed: the multihost pump reads its source pull-synchronously, so a
slow host drops nothing.
"""

import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from webradio_tpu_torch.parallel import mesh as pmesh
from webradio_tpu_torch.parallel import multihost

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

WORKER = pathlib.Path(__file__).parent / "torch_multiproc_app_worker.py"

TUNER = {
    "driver": "tone",
    "centre_frequency": 100_000_000,
    "sample_rate": 1_024_000,
    "channel_rate": 128_000,
    "audio_rate": 32_000,
    "block_frames": 10_240,
    "capacity": 4,
    "engine": "sharded",
    "multihost": True,
}


@pytest.fixture
def app_factory(monkeypatch):
    from webradio_tpu_torch.app import RadioApp
    from webradio_tpu_torch.radio import Radio
    from webradio_tpu_torch.web.audiostream import AudioStreamManager

    monkeypatch.setattr(pmesh, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * 8)
    apps = []

    def make(receivers):
        config = {"server": {"port": 0, "host": "127.0.0.1", "html": "html"},
                  "tuners": [dict(TUNER)], "receivers": receivers}
        app = RadioApp(config, device="cpu")
        apps.append(app)
        return app

    yield make
    for app in apps:
        app.close()
    Radio.reset()
    AudioStreamManager.reset()


def _req(port, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body,
                 headers={"Host": "127.0.0.1",
                          "Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def _wait_blocks(app, fe, n):
    deadline = time.time() + 120
    while fe.block_count < n and time.time() < deadline:
        assert app.failed is None, app.failed
        time.sleep(0.05)
    assert fe.block_count >= n, "the multihost pump produced no blocks"


def _tone(raw, rate, skip):
    x = np.frombuffer(raw[44:], "<i2").astype(np.float64)[skip:]
    spec = np.abs(np.fft.rfft((x - x.mean()) * np.hanning(x.size)))
    return np.argmax(spec) * rate / x.size


def test_multihost_degenerate_single_process(app_factory):
    import http.client

    app = app_factory([{"tuner": 0, "if_frequency": 0,
                        "demodulator": "AM"}])
    assert app.start()
    fe = app.front_ends[0]
    assert type(fe.pipeline).__name__ == "ShardedChannelizedFrontEnd"
    assert fe.pipeline.mesh.shape == {"time": 2, "chan": 4}
    assert fe._mh_slice == (0, 10_240)  # one process owns every row
    _wait_blocks(app, fe, 4)
    port = app.server.port
    st, body = _req(port, "GET", "/status")
    assert st == 200
    fe_st = json.loads(body)["front_ends"][fe.uuid]
    assert fe_st["blocks"] >= 4 and fe_st["engine"] == "channelized"
    assert fe_st["dropped_blocks"] == 0  # pull-synchronous: no ring

    # a poll turns the spectrum gather on for the rounds that follow it (as
    # the UI's 5 Hz polls do); poll until a gathered row arrives
    deadline = time.time() + 120
    while True:
        st, body = _req(port, "GET", f"/tuners/{fe.uuid}/waterfall")
        data = np.array(json.loads(body)["data"])
        assert st == 200 and data.size > 0
        if data.max() > -1000 or time.time() > deadline:
            break
        time.sleep(0.1)
    assert data.max() > -1000, "no spectrum row was gathered"

    # the AM receiver's 1 kHz over HTTP
    rx = app.receivers[0].uuid
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("GET", f"/audio/{rx}.wav", headers={"Host": "127.0.0.1"})
    resp = conn.getresponse()
    assert resp.status == 200
    raw = resp.read(44 + 2 * 16_000)
    conn.close()
    assert raw[:4] == b"RIFF"
    assert abs(_tone(raw, 32_000, 4_000) - 1_000) < 50

    # a control write while the pump runs applies at a round boundary
    st, _ = _req(port, "PUT", f"/receivers/{rx}",
                 json.dumps({"if_frequency": 20_000}).encode())
    assert st in (200, 204)
    _wait_blocks(app, fe, fe.block_count + 3)
    assert int(fe.pipeline.params.residual_step[0]) != 0
    assert fe._mh_settings[0][0] == 20_000
    assert app.failed is None


def test_multihost_post_past_capacity_409(app_factory):
    """A POST past capacity under multihost serving answers 409 with a
    JSON body; the receiver does not leak and the pump keeps running."""
    from webradio_tpu_torch.radio import Radio

    app = app_factory([{"tuner": 0, "if_frequency": 10_000,
                        "demodulator": "FM"}])
    assert app.start()
    fe = app.front_ends[0]
    port = app.server.port
    _wait_blocks(app, fe, 2)
    for i in range(3):
        st, body = _req(port, "POST", "/receivers", json.dumps({
            "tuner": f"/tuners/{fe.uuid}", "if_frequency": 15_000 + 5_000 * i,
            "demodulator": "FM"}).encode())
        assert st == 201, (st, body)
    assert len(fe.receivers) == 4
    known = set(Radio.receivers)
    st, body = _req(port, "POST", "/receivers", json.dumps({
        "tuner": f"/tuners/{fe.uuid}", "if_frequency": 40_000,
        "demodulator": "FM"}).encode())
    assert st == 409, (st, body)
    err = json.loads(body)
    assert err["capacity"] == 4 and err["attached"] == 4
    assert "multihost" in err["error"]
    assert len(fe.receivers) == 4 and set(Radio.receivers) == known
    assert fe.cfg.num_channels == 4
    _wait_blocks(app, fe, fe.block_count + 3)
    assert app.failed is None


def _reader(proc, sink):
    for line in proc.stdout:
        sink.append(line)


def test_two_process_multihost_live_app(tmp_path):
    url = f"file://{tmp_path / 'rendezvous'}"
    procs, outs = [], [[], []]
    try:
        for i in range(2):
            p = subprocess.Popen(
                [sys.executable, str(WORKER), url, "2", str(i)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append(p)
            threading.Thread(target=_reader, args=(p, outs[i]),
                             daemon=True).start()
        deadline = time.time() + 240
        step0 = follower_ok = None
        while time.time() < deadline and not follower_ok:
            if step0 is None:
                for ln in outs[0]:
                    if ln.startswith("RANK0_STEP"):
                        step0 = int(ln.split()[1])
            if step0 is not None and any("MULTIHOST_APP_OK" in ln
                                         for ln in outs[0]):
                # rank 1's parameters after the write: rank 0's step
                follower_ok = any(
                    ln.startswith("FOLLOWER") and int(ln.split()[2]) == step0
                    for ln in outs[1])
            if any(p.poll() is not None for p in procs):
                break
            time.sleep(0.2)
        log0 = "".join(outs[0])[-3000:]
        log1 = "".join(outs[1])[-3000:]
        assert step0 is not None, f"rank 0 did not finish:\n{log0}\n{log1}"
        assert follower_ok, f"rank 1 never took the write:\n{log1}\n{log0}"
    finally:
        # both ranks serve on; a clean stop of one would leave the other in
        # a collective: kill both
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=10)


def test_control_blob_of_a_4096_slot_burst_splits_and_applies():
    """A burst of writes to every slot of a 4,096-slot front end: the
    round's blob is several broadcast buffers long and reassembles whole,
    and the round applies it as one slot scatter equal to a full build."""
    from webradio_tpu_torch.io.tuner import ToneTuner
    from webradio_tpu_torch.pipeline import channelized as ch
    from webradio_tpu_torch.pipeline.state import ChainConfig
    from webradio_tpu_torch.radio import FrontEnd, Radio, Receiver

    tuner = ToneTuner()
    tuner.source.realtime = False
    chain = ChainConfig(sample_rate=1_024_000, channel_rate=128_000,
                        audio_rate=32_000, block_frames=10_240)
    fe = FrontEnd(tuner, chain, capacity=4_096, engine="sharded",
                  multihost=True, device="cpu")
    try:
        assert fe.start()
        for i in range(4_096):
            rx = Receiver()
            rx.update(if_frequency=(i * 97) % 500_000 - 250_000,
                      demodulator=("AM", "FM", "USB", "LSB")[i % 4])
            rx.set_front_end(fe)
        assert len(fe._mh_dirty) == 4_096
        blob = fe._control_blob()
        payload = json.dumps(blob).encode()
        assert len(payload) > 2 * multihost.CONTROL_BLOB_BYTES
        frames = multihost.frame_blob(payload)
        assert len(frames) == -(-len(payload)
                                // multihost.CONTROL_BLOB_BYTES)
        parts, more = [], None
        for buf in frames:
            assert buf.shape == (8 + multihost.CONTROL_BLOB_BYTES,)
            part, more = multihost.read_frame(buf)
            parts.append(part)
        assert more == 0 and b"".join(parts) == payload
        fe._apply_control_blob(json.loads(payload))
        width = fe.pipeline.cfg.num_channels
        full = ch.make_channelized_params(
            fe.pipeline.cfg, *fe._slot_settings(width), device="cpu")
        for name in ("residual_step", "mode", "pfb_weights"):
            torch.testing.assert_close(getattr(fe.pipeline.params, name),
                                       getattr(full, name), rtol=0, atol=0)
        assert fe.pipeline.params.chan_toep is not None  # scattered
        assert fe.run_once()  # the next round: nothing written
    finally:
        fe.close()
        Radio.reset()
