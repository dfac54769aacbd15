"""Package-level properties of the PyTorch port: it never imports JAX, the
kernel build raises (never falls back) where nvcc is missing, and the
chip smoke script refuses to run without a CUDA device."""

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
import webradio_tpu.io.source  # the host I/O the port shares
print(len(names), sorted(m for m in sys.modules if m.split(".")[0] == "jax"))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    count, jax_modules = out.stdout.split(maxsplit=1)
    assert int(count) >= 15  # every submodule was imported
    assert jax_modules.strip() == "[]"


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
    assert all(p.is_file() for p in _build.SOURCES)


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
