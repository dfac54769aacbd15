"""Two real processes on ``torch.distributed`` (gloo) drive the port's
sharded channelized step: the twin of ``tests/test_multiprocess.py``.

Each process (``tests/torch_multiproc_worker.py``) owns one time row of a
(time=2, chan=2) mesh, ingests only its own time slice of the capture, and
holds the audio gathered across both ranks, and the carried state, to the
port's single-device step (see the worker for the bounds). The process
group comes up through a file under ``tmp_path`` (no port to race for),
and no process group is made in the pytest process.
"""

import pathlib
import subprocess
import sys

WORKER = pathlib.Path(__file__).parent / "torch_multiproc_worker.py"


def test_two_process_sharded_step(tmp_path):
    url = f"file://{tmp_path / 'rendezvous'}"
    procs = [
        subprocess.Popen([sys.executable, str(WORKER), url, "2", str(i)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
        assert "MULTIPROC_OK" in out, f"rank {i}: no OK marker:\n{out[-3000:]}"
