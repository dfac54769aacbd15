"""Worker of ``tests/test_torch_multihost_app.py``'s two-process case (run
as a subprocess): one rank of the port's LIVE app under multihost serving.

Both ranks boot ``RadioApp`` from the same topology: a tone tuner at 1.024
Msps, ``engine="sharded"``, ``multihost: true``, capacity 512 (the
channelized width from which "auto" takes the fused tail), ``distributed``
over a file rendezvous on gloo, on the CPU. Each rank drives two CPU
positions (its ``visible_devices`` replaced in-process, as the tests do),
so the global mesh is (time=2, chan=2) and each rank ingests half of every
block. The app's own pump thread runs the lockstep schedule on both.

Rank 0 (HTTP): waits for blocks, reads /status and the waterfall, hears
the AM receiver's 1 kHz over HTTP (its rows are gathered from both ranks),
retunes it with a PUT (which must reach rank 1 through the control
broadcast), prints ``RANK0_STEP <slot 0's residual step>`` after the write
applied and ``MULTIHOST_APP_OK``. Rank 1 prints ``FOLLOWER <blocks> <slot
0's residual step>`` every ten blocks. Both serve until the parent kills
them (a clean stop of one rank would leave the other in a collective).
Imports neither JAX nor the JAX package.

Usage: python torch_multiproc_app_worker.py <init-url> <num_procs> <rank>
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    url, num, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import numpy as np
    import torch

    torch.sin(torch.zeros(1))  # see the test files' note on torch's CPU math
    torch.set_num_threads(2)  # beside the other test workers' CPU use
    from webradio_tpu_torch.parallel import mesh as pmesh

    pmesh.visible_devices = lambda device=None: [torch.device("cpu")] * 2
    from webradio_tpu_torch.app import RadioApp

    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "distributed": {"coordinator": url, "num_processes": num,
                        "process_id": rank, "backend": "gloo"},
        "tuners": [{
            "driver": "tone", "centre_frequency": 100_000_000,
            "sample_rate": 1_024_000, "channel_rate": 128_000,
            "audio_rate": 32_000, "block_frames": 10_240,
            "capacity": 512, "engine": "sharded", "multihost": True,
        }],
        "receivers": [{"tuner": 0, "if_frequency": 0, "demodulator": "AM"}],
    }
    app = RadioApp(config, device="cpu")
    assert app.start(), "app failed to start"
    assert pmesh.world() == (rank, num)
    fe = app.front_ends[0]
    assert fe.pipeline.mesh.shape == {"time": 2, "chan": 2}

    if rank != 0:
        assert app.server is None  # HTTP lives on rank 0 only
        last = 0
        while app.failed is None:
            if fe.block_count >= last + 10:
                last = fe.block_count
                print("FOLLOWER", last,
                      int(fe.pipeline.params.residual_step[0]), flush=True)
            time.sleep(0.05)
        raise app.failed

    import http.client

    def req(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                          timeout=60)
        conn.request(method, path, body=body,
                     headers={"Host": "127.0.0.1",
                              "Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
        conn.close()
        return r.status, data

    def wait_blocks(n):
        deadline = time.time() + 120
        while fe.block_count < n and time.time() < deadline:
            assert app.failed is None, app.failed
            time.sleep(0.05)
        assert fe.block_count >= n, "the pump stalled"

    wait_blocks(5)
    st, body = req("GET", "/status")
    assert st == 200, st
    fe_st = json.loads(body)["front_ends"][fe.uuid]
    assert fe_st["blocks"] >= 5 and fe_st["engine"] == "channelized"
    # a poll turns the spectrum gather on for the rounds that follow it
    # (as the UI's 5 Hz polls do); poll until a gathered row arrives
    deadline = time.time() + 120
    while True:
        st, body = req("GET", f"/tuners/{fe.uuid}/waterfall")
        data = np.array(json.loads(body)["data"], np.float64)
        assert st == 200 and data.size > 0, st
        if data.max() > -1000 or time.time() > deadline:
            break
        time.sleep(0.1)
    assert data.max() > -1000, "no spectrum row was gathered"

    rx = app.receivers[0].uuid
    conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                      timeout=120)
    conn.request("GET", f"/audio/{rx}.wav", headers={"Host": "127.0.0.1"})
    resp = conn.getresponse()
    assert resp.status == 200, resp.status
    raw = resp.read(44 + 2 * 12_000)  # 0.375 s at 32 kHz
    conn.close()
    assert raw[:4] == b"RIFF"
    x = np.frombuffer(raw[44:], "<i2").astype(np.float64)[4_000:]
    spec = np.abs(np.fft.rfft((x - x.mean()) * np.hanning(x.size)))
    tone = np.argmax(spec) * 32_000 / x.size
    assert abs(tone - 1_000) < 50, tone

    st, _ = req("PUT", f"/receivers/{rx}",
                json.dumps({"if_frequency": 20_000}).encode())
    assert st in (200, 204), st
    wait_blocks(fe.block_count + 3)
    step = int(fe.pipeline.params.residual_step[0])
    assert step != 0  # the write applied here
    print("RANK0_STEP", step, flush=True)
    print("MULTIHOST_APP_OK", fe.block_count, flush=True)
    while app.failed is None:
        time.sleep(0.2)
    raise app.failed


if __name__ == "__main__":
    main()
