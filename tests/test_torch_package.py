"""Package-level properties of the PyTorch port: neither it nor the chip
smoke script nor ``bench_torch.py`` imports JAX or the JAX package, the
kernel build raises (never falls back) where nvcc is missing, and the chip
smoke script refuses to run without a CUDA device."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import webradio_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    webradio_tpu_torch.__path__, "webradio_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"webradio_tpu_torch.parallel." + m for m in (
    "mesh", "comm", "sharded", "sharded_channelized", "multihost")} <= set(
    names), names
import chip_smoke
chip_smoke.tone_blocks(1)  # its sample source is the port's own
import bench_torch
bench_torch.bench_iq(bench_torch.device_of("cpu"), 12_800)
print(len(names), sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "webradio_tpu")))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax():
    # after importing every module of the port, chip_smoke and bench_torch
    # (and making the bench's input): no jax, and
    # no webradio_tpu or webradio_tpu.* module
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    count, foreign = out.stdout.split(maxsplit=1)
    assert int(count) >= 20  # every submodule was imported
    assert foreign.strip() == "[]"


def test_no_source_line_imports_the_jax_package():
    # the card's host has no JAX: the multi-process workers import neither
    files = [REPO / "chip_smoke.py", REPO / "bench_torch.py",
             REPO / "tests" / "torch_multiproc_worker.py",
             REPO / "tests" / "torch_multiproc_app_worker.py",
             *(REPO / "webradio_tpu_torch").rglob("*.py")]
    assert len(files) > 20
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                root = words[1].split(".")[0]
                assert root not in ("jax", "webradio_tpu"), (path, line)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from webradio_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.nvcc_path() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library(build_dir=tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_build_is_keyed_by_the_sources(tmp_path):
    from webradio_tpu_torch.ops import _build

    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build._digest([src])
    src.write_text("// two\n")
    assert _build._digest([src]) != first
    # a header the sources include is part of the key too
    hdr = tmp_path / "k.cuh"
    hdr.write_text("// a\n")
    with_hdr = _build._digest([src], [hdr])
    hdr.write_text("// b\n")
    assert _build._digest([src], [hdr]) != with_hdr
    assert all(p.is_file() for p in (*_build.SOURCES, *_build.HEADERS))
    assert {p.name for p in _build.SOURCES} == {"tail_tm.cu", "tail.cu"}


def test_chip_smoke_refuses_without_a_card(tmp_path):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the rest of the repo
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    alone = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=alone, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
