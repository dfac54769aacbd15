"""Finds a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root
names the cell, its configuration and its traffic mix; each lives in a file
of its own under this folder:

- ``configs/<config>.json``: the deployment (topology, source, what was
  assumed and changed, the limits of the outputs check);
- ``traffic/<traffic>.json``: the mix (the loop: open at the tuner's
  rate, or closed with ``in_flight`` blocks; listeners, squelched ones
  among them; retunes and spectrum polls a second); the band and the ring
  of blocks are ``signal.py``'s, the same in every mix;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns a number or None where it finds nothing to read.

A later change adds a cell, a mix, a configuration or a metric by adding
files and entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


class CellError(LookupError):
    """A cell, or a file it names, that is not there or is malformed."""


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    reader: object = None  # a per-layer metric's module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: pathlib.Path

    @property
    def tuner(self) -> dict:
        return self.config["topology"]["tuners"][0]


def _load_json(path: pathlib.Path, what: str) -> dict:
    if not path.is_file():
        raise CellError(f"{what}: no file {path}")
    try:
        return json.loads(path.read_text())
    except ValueError as e:
        raise CellError(f"{what}: {path} is not JSON ({e})") from e


def load_reader(path: pathlib.Path):
    """A metric's reader module, loaded from its file by path (a metric's
    name may hold dots, which an import name may not)."""
    if not path.is_file():
        raise CellError(f"metric reader: no file {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise CellError(f"metric reader {path} has no read(run)")
    return module


def _applies(spec: dict, cell: str) -> bool:
    return "workloads" not in spec or cell in spec["workloads"]


def find_cell(name: str, root: pathlib.Path | str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its
    configuration, its mix, and the metrics it reports; raises
    :class:`CellError` where the cell or one of its files is missing."""
    root = pathlib.Path(root)
    bench = _load_json(root / "BENCHMARK.json", "benchmark")
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    if name not in cells:
        raise CellError(f"no cell {name!r} in {root / 'BENCHMARK.json'} "
                        f"(cells: {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench.get("configs", [])}
    if w["config"] not in configs:
        raise CellError(f"cell {name!r}: no configuration {w['config']!r}")
    config = _load_json(root / configs[w["config"]]["file"],
                        f"configuration {w['config']!r}")
    traffic = _load_json(root / HERE.name / "traffic"
                         / f"{w['traffic']}.json", f"traffic {w['traffic']!r}")
    e2e = [Metric(m["name"], m["unit"], m["better"], m["source"])
           for m in bench.get("end_to_end", []) if _applies(m, name)]
    per_layer = [Metric(m["name"], m["unit"], m["better"], m["source"],
                        load_reader(root / HERE.name / "metrics"
                                    / f"{m['name']}.py"))
                 for m in bench.get("per_layer", []) if _applies(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                root=root)
