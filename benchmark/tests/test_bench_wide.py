"""The ``wide_highest4.bulk`` cell on the CPU: its configuration's own file
at a small capacity, served by the sharded engine over four CPU positions
(``parallel.mesh.visible_devices`` replaced, as the program's tests build
their meshes), is correct against the plain reference, with the listened
receivers spread two to a position; a fault confined to one position is
not correct.

    python3 -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from benchmark import registry, run
from benchmark.tests.test_bench_harness import REPO

#: slots of the stand-in: 16 a position
CAPACITY = 64


def wide_stand_in(root) -> str:
    """``wide_highest4.bulk`` as new files under ``root``: the cell's own
    configuration and mix, its capacity cut to :data:`CAPACITY`."""
    src = REPO / "benchmark"
    (root / "benchmark" / "configs").mkdir(parents=True)
    shutil.copytree(src / "traffic", root / "benchmark" / "traffic")
    shutil.copytree(src / "metrics", root / "benchmark" / "metrics")
    cfg = json.loads((src / "configs" / "wide_highest4.json").read_text())
    cfg["topology"]["tuners"][0]["capacity"] = CAPACITY
    (root / "benchmark" / "configs" / "wide_highest4.json").write_text(
        json.dumps(cfg))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return "wide_highest4.bulk"


@pytest.fixture
def four_positions(monkeypatch):
    from webradio_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * 4)


def _zero_one_position(r):
    """The audio of the position that holds the first listened receiver
    on a carrier zeroed after every block: a fault of one shard alone."""
    pipe = r.fe.pipeline
    assert pipe.mesh.shape == {"time": 1, "chan": 4}
    i = next(i for i, rx in enumerate(r.plan.receivers)
             if rx.kind == "carrier")
    p = r.probe.slot_of[i] // pipe.c_local
    step = pipe._run

    def faulty(block):
        out = step(block)
        out["audio"][p].zero_()
        return out

    pipe._run = faulty
    r.faulty_position = p


@pytest.mark.parametrize("fault", [None, _zero_one_position],
                         ids=["sound", "one_position"])
def test_the_wide_cell_over_four_positions(tmp_path, four_positions, fault,
                                           small_run):
    cell = registry.find_cell(wide_stand_in(tmp_path), tmp_path)
    assert cell.chips == 4 and cell.tuner["capacity"] == CAPACITY
    seen = {}

    def hook(r):
        pipe = r.fe.pipeline
        seen["per_position"] = sorted(
            sum(1 for s in r.probe.slot_of.values()
                if s // pipe.c_local == p) for p in range(4))
        if fault is not None:
            fault(r)

    out = run.measure(cell, 2**31 + 19, 1.0, False, device="cpu", fault=hook)
    assert seen["per_position"] == [2, 2, 2, 2]
    assert out["attempted"] > out["failed"]
    if fault is None:
        assert out["correct"], (out["checks"], out["failed"])
        assert out["metrics"]["rt_factor"]["value"] > 0
    else:
        assert not out["correct"], out["checks"]
        gap = out["checks"]["audio_gap"]
        assert gap["value"] > gap["limit"]
