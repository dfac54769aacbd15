"""The benchmark's harness on the CPU: finding a cell's pieces by name, a
stand-in cell added from files alone and run end to end, the open loop's
schedule, the end-to-end arithmetic, and the modules a run loads.

    python3 -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from benchmark import check, harness, registry, roofline, run

REPO = pathlib.Path(__file__).resolve().parents[2]


def stand_in(root: pathlib.Path, mix: str = "bulk", capacity: int = 64,
             engine: str = "channelized", metric: bool = True) -> str:
    """A cell of 64 slots, four listeners, made of new files only under
    ``root``: a configuration, a mix, a metric reader and a
    ``BENCHMARK.json`` naming them. Returns the cell's name."""
    src = REPO / "benchmark"
    (root / "benchmark" / "configs").mkdir(parents=True)
    (root / "benchmark" / "traffic").mkdir()
    shutil.copytree(src / "metrics", root / "benchmark" / "metrics")
    cfg = json.loads((src / "configs" / "headline_u8.json").read_text())
    cfg["name"] = "tiny"
    tuner = cfg["topology"]["tuners"][0]
    tuner["capacity"], tuner["engine"] = capacity, engine
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((src / "traffic" / f"{mix}.json").read_text())
    tr.update(listeners=4, squelched_listeners=1)
    (root / "benchmark" / "traffic" / "tiny_mix.json").write_text(
        json.dumps(tr))
    if metric:
        (root / "benchmark" / "metrics" / "blocks_seen.tiny.py").write_text(
            "def read(run):\n    return float(len(run.blocks)) or None\n")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "stand-in",
                         "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "a test"}]
    bench["workloads"] = [{"name": "tiny.cell", "config": "tiny",
                           "traffic": "tiny_mix", "chips": 1,
                           "why": "a test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = ["tiny.cell"]
    if metric:
        bench["per_layer"].append({
            "name": "blocks_seen.tiny", "unit": "blocks", "better": "higher",
            "source": "program_counter", "layer": "topology pump",
            "moves": "rt_factor", "workloads": ["tiny.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "tiny.cell"


def test_finds_every_cell_of_the_repo():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = registry.find_cell(w["name"], REPO)
        assert cell.chips == w["chips"]
        assert cell.config["name"] == w["config"]
        assert cell.traffic["loop"] in ("open", "closed")
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer and all(callable(m.reader.read)
                                      for m in cell.per_layer)


@pytest.mark.parametrize("missing", ["cell", "config", "traffic", "metric"])
def test_a_cell_whose_files_are_missing_is_refused(tmp_path, missing):
    name = stand_in(tmp_path)
    if missing == "config":
        (tmp_path / "benchmark" / "configs" / "tiny.json").unlink()
    elif missing == "traffic":
        (tmp_path / "benchmark" / "traffic" / "tiny_mix.json").unlink()
    elif missing == "metric":
        (tmp_path / "benchmark" / "metrics" / "blocks_seen.tiny.py").unlink()
    else:
        name = "no.such.cell"
    with pytest.raises(registry.CellError):
        registry.find_cell(name, tmp_path)


@pytest.mark.parametrize("mix", ["bulk", "live"])
def test_a_stand_in_cell_runs_from_files_alone(tmp_path, mix, small_run):
    """A cell added as files and entries only runs on the CPU, checks its
    outputs, and reports its own metric reader's number. (On a loaded
    host the CPU's step can fall behind the tuner's rate and the ring drop
    blocks: the run counts them as failed, and its answers stay right.)"""
    cell = registry.find_cell(stand_in(tmp_path, mix), tmp_path)
    out = run.measure(cell, 2**31 + 12345, 1.0, False, device="cpu")
    assert out["correct"], (out["checks"], out["failed"], out["attempted"])
    assert out["attempted"] > out["failed"]
    assert list(out)[-1] == "checks"
    key = "rt_factor" if mix == "bulk" else "block_p95_ms"
    assert out["metrics"][key]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    reader = [m for m in cell.per_layer if m.name == "blocks_seen.tiny"]
    assert reader and reader[0].reader.read(
        type("View", (), {"blocks": [1, 2]})()) == 2.0


def test_the_window_s_answers_stay_compared_however_long_it_takes_to_close(
        tmp_path, monkeypatch, small_run):
    """A run that takes seconds to close after its window (a traced run
    stops its profiler there) while the tuner's blocks go on: the window's
    latest blocks are still compared, not lost."""
    cell = registry.find_cell(stand_in(tmp_path, "live"), tmp_path)
    counts = harness.Run._counts

    def slow_close(self):
        if getattr(self, "counts", None):  # the window has closed
            time.sleep(2.0)  # some 47 blocks at the tuner's rate
        return counts(self)

    monkeypatch.setattr(harness.Run, "_counts", slow_close)
    out = run.measure(cell, 2**31 + 99, 1.0, False, device="cpu")
    assert out["correct"], (out["checks"], out["failed"])
    assert out["checks"]["missing"]["value"] == 0


class _StallingPump:
    """A stand-in for the front end whose pump takes nothing for a while:
    the ring fills and drops, and the generator goes on."""

    def __init__(self):
        from webradio_tpu_torch.io.ring import BlockRing

        self.ring = BlockRing(4)
        self.puts = []
        self.blocks = {}

    def put(self, block, seq):
        self.puts.append((seq, time.perf_counter()))
        self.ring.put(block)

    def block(self, seq):
        return self.blocks.setdefault(seq, harness.Block(seq))


def test_open_loop_schedule_does_not_slow_when_the_consumer_stalls():
    r = harness.Run.__new__(harness.Run)
    r.traffic = {"loop": "open"}
    r.period = 0.01
    r.pool = [np.zeros((2, 8), np.float32)]
    stand = _StallingPump()
    r.probe, r.fe = stand, stand
    r.offered, r.sample = [], check.Reservoir(0)
    r._stop_gen = threading.Event()
    r.t0 = time.perf_counter() + 0.01
    r.t_w0, r.t_w1 = r.t0, r.t0 + 0.3
    gen = threading.Thread(target=r._generate)
    gen.start()
    time.sleep(0.5)  # nobody reads the ring all this while
    r._stop_gen.set()
    gen.join()
    late = [t - (r.t0 + seq * r.period) for seq, t in stand.puts]
    assert len(stand.puts) >= 40
    # a schedule that waited on the stalled consumer would put every block
    # after the first few the whole stall (0.5 s) late; a shared host's
    # jitter makes a put a few milliseconds late now and then
    assert max(late) < 0.05 and np.median(late) < 0.002
    assert stand.ring.dropped_blocks == len(stand.puts) - 4
    assert len(r.offered) == 30


@pytest.mark.parametrize("kind", ["ring", "fanout"])
def test_the_blocks_a_queue_drops_are_the_ones_noted(kind):
    """``watch_drops`` notes the block a drop-oldest queue dropped as it
    counted it, and none that a consumer took first."""
    from webradio_tpu_torch.io.ring import BlockRing
    from webradio_tpu_torch.radio import DropOldestQueue

    if kind == "ring":
        q, counter = BlockRing(2), "dropped_blocks"
        lock = q._lock
    else:
        q, counter = DropOldestQueue(2), "dropped"
        lock = q._cv
    noted: set = set()
    harness.watch_drops(q, lock, counter, lambda item: [item], noted)
    for seq in range(3):
        q.put(seq)
    assert noted == {0} and getattr(q, counter) == 1
    assert q.get(0.1) == 1  # a consumer takes the oldest first
    q.put(3)
    assert noted == {0} and getattr(q, counter) == 1
    q.put(4)
    assert noted == {0, 2} and getattr(q, counter) == 2


def _run_for_arithmetic(loop: str):
    r = harness.Run.__new__(harness.Run)
    r.traffic = {"loop": loop}
    r.period, r.seconds = 0.04, 1.0
    r.t_w0, r.t_w1 = 100.0, 101.0
    r.t_end_wait = 103.0
    r.listeners = [None, None]
    r.probe = type("P", (), {})()
    blocks = {}
    for s in range(30):
        b = harness.Block(s, due=100.0 + s * 0.04, put=100.0 + s * 0.04)
        b.reads, b.last_read = 2, 100.0 + s * 0.04 + 0.001 * (s + 1)
        blocks[s] = b
    blocks[7].reads = 1  # one listener never read block 7
    r.probe.blocks = blocks
    r.offered = list(range(25))
    return r


def test_open_loop_arithmetic():
    r = _run_for_arithmetic("open")
    out = r.end_to_end(12.5)
    assert out["attempted"] == 25 and out["failed"] == 1
    lat = [0.001 * (s + 1) for s in range(25)]
    lat[7] = 103.0 - (100.0 + 7 * 0.04)  # undelivered: up to the end
    assert out["block_p95_ms"] == pytest.approx(1e3 * np.percentile(lat, 95))
    assert out["setup_s"] == 12.5


def test_closed_loop_arithmetic():
    r = _run_for_arithmetic("closed")
    out = r.end_to_end(3.0)
    # blocks read by both listeners inside [100, 101): 0..24, less block 7
    inside = [s for s in range(30) if s != 7
              and 100.0 + s * 0.04 + 0.001 * (s + 1) < 101.0]
    assert out["rt_factor"] == pytest.approx(len(inside) * 0.04 / 1.0)
    assert out["attempted"] == 25 and out["failed"] == 1


def test_copied_roofline_is_kernel_1s_at_1024_channels():
    assert roofline.roofline_ms(1_024, "highest")["tail_ms"] == \
        pytest.approx(0.0456, rel=0.01)


def test_no_jax_module_in_a_run_process():
    """Importing the harness, the reference, the program's modules a run
    uses and running the reference loads no module whose top-level name is
    ``jax`` or ``webradio_tpu`` (the port, ``webradio_tpu_torch``, is
    another name)."""
    code = (
        "import sys, numpy as np\n"
        "from benchmark import run, harness, reference, check, control, "
        "tracing, profile, signal\n"
        "import webradio_tpu_torch.app, webradio_tpu_torch.radio\n"
        "chain = reference.Chain({})\n"
        "reference.spectrum_row(np.zeros((2, 512)) + 0.5)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names, found = out.stdout.strip().splitlines()[-2:]
    tops = set(eval(names))
    assert "webradio_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "webradio_tpu"}
    assert eval(found) == []


def test_the_run_refuses_without_a_card(tmp_path):
    """Without the cards a cell asks for, a run prints no result."""
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "headline_u8.bulk", "--seed", "1", "--seconds", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
