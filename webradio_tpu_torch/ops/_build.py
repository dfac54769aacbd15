"""Build and bind the package's CUDA kernels (nvcc + ctypes).

The kernels are plain CUDA C++ with a C entry point (``csrc/*.cu``). At
first use they are compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``webradio_tpu_torch/_build/``, named by a hash of the
sources and flags, and loaded with ``ctypes``. Nothing is prebuilt and
nothing is downloaded: the build reads only the package's own sources.

Where ``nvcc`` cannot be found the build raises; callers never fall back to
a plain version for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
#: one translation unit per file, compiled side by side and linked into one
#: library
SOURCES = (CSRC_DIR / "tail_tm.cu", CSRC_DIR / "tail.cu")
#: headers the sources include; part of the cache key
HEADERS = (CSRC_DIR / "tail_common.cuh",)
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc_path() -> str | None:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``); None when neither has it."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    return str(cand) if cand.is_file() and os.access(cand, os.X_OK) else None


def _digest(sources, headers=()) -> str:
    h = hashlib.sha256()
    for src in (*sources, *headers):
        h.update(pathlib.Path(src).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library(sources=SOURCES, build_dir=BUILD_DIR,
                  headers=HEADERS) -> pathlib.Path:
    """Compile ``sources`` into one shared library (cached by content).

    Every source is compiled to an object file by its own ``nvcc`` process,
    all started together, and the objects are linked into one library.
    Returns the library path; the compiler's output (including
    ``-Xptxas -v`` register, shared-memory and spill figures) is kept
    beside it as ``<name>.log``. Raises RuntimeError when ``nvcc`` is
    missing or fails.
    """
    build_dir = pathlib.Path(build_dir)
    out = build_dir / f"libwebradio_kernels_{_digest(sources, headers)}.so"
    if out.is_file():
        return out
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "cannot build the CUDA kernels: nvcc not found on PATH or under "
            "$CUDA_HOME/bin (set CUDA_HOME to the CUDA toolkit)"
        )
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objects = [build_dir / f"{tag}.{pathlib.Path(s).stem}.o" for s in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    log, failed = [], []
    for cmd, proc in zip(cmds, procs):
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append((proc.returncode, text))
    tmp = build_dir / f"{tag}.tmp.so"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objects)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append((proc.returncode, proc.stderr))
    out.with_suffix(".log").write_text("\n".join(log))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        code, text = failed[0]
        raise RuntimeError(f"nvcc failed (exit {code}):\n{text}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's C signature
    declared (pointers and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(str(build_library()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # (pointers..., ints..., stream): see the extern "C" block of each source
    tail = [vp] * 16 + [i32] * 8 + [vp]
    # the audio-fused tail takes the kernel body before the device
    lib.webradio_tail_tm_launch.argtypes = (
        [vp, vp, i64] + [vp] * 16 + [i32] * 9 + [vp])
    lib.webradio_pfb_tail_tm_launch.argtypes = [vp, vp, vp, i32] + tail
    lib.webradio_tail_tm_chanrate_launch.argtypes = (
        [vp, vp, i64] + [vp] * 13 + [i32] * 7 + [vp])
    lib.webradio_receiver_tail_launch.argtypes = (
        [vp] * 11 + [i32] * 4 + [vp])
    for name in ("webradio_tail_tm_launch", "webradio_pfb_tail_tm_launch",
                 "webradio_tail_tm_chanrate_launch",
                 "webradio_receiver_tail_launch"):
        getattr(lib, name).restype = i32
    err = lib.webradio_tail_tm_error_string
    err.argtypes = [i32]
    err.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.webradio_tail_tm_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
