"""ctypes bindings for the native ingest runtime (the repo's
``native/src/ingest.cpp``): the port's own copy of
``webradio_tpu.io.native``.

The reference's capture path is C++ (u8 -> float conversion plus a
mutex/condvar block ring on a dedicated thread, src/io/rtlsdrtuner.cxx);
this binds the same native core. At first use the source is compiled with
``g++`` into ``webradio_tpu_torch/_build/`` (never into ``native/``), named
by a hash of the source and the flags: under an ``fcntl`` lock, to a
temporary name first and then moved into place with ``os.replace``, so a
process that finds the library finds all of it. Where the build fails,
``available()`` is False and callers use the pure-Python paths (same
semantics, more GIL traffic).

Build by hand with ``python -m webradio_tpu_torch.io.native``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE_DIR.parent / "native" / "src" / "ingest.cpp"
BUILD_DIR = _PACKAGE_DIR / "_build"
#: no -march=native: the build directory may travel to another host. The
#: source calls snprintf without including <cstdio>, which newer libstdc++
#: headers no longer pull in on their own, hence the forced include.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared",
             "-include", "cstdio")

_lib = None
_failed = False  # a build or load failed once: not retried per call
_lib_lock = threading.Lock()


def library_path(source: pathlib.Path = SOURCE,
                 build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Where the library built from ``source`` lives (keyed by content)."""
    h = hashlib.sha256(pathlib.Path(source).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return pathlib.Path(build_dir) / f"libwebradio_ingest_{h.hexdigest()[:16]}.so"


def build(source: pathlib.Path = SOURCE,
          build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path | None:
    """Compile ``source`` (g++, no extra dependencies) unless its library
    exists; returns the library path, None where the build failed.

    Concurrent builders (threads, processes) serialize on a lock file in
    ``build_dir``; the compiler writes a name of its own and the finished
    file is renamed into place, so no reader sees a partial library."""
    if not pathlib.Path(source).is_file():
        log.warning("native source %s not found", source)
        return None
    out = library_path(source, build_dir)
    if out.is_file():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        log.warning("native build: no C++ compiler found")
        return None
    build_dir = pathlib.Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".ingest.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.is_file():  # another builder finished while we waited
                return out
            tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, str(source), "-o", str(tmp)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                log.warning("native build failed:\n%s", proc.stderr)
                return None
            os.replace(tmp, out)
            return out
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i64, c_int, c_void = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.wr_convert_u8_iq.argtypes = [u8p, f32p, f32p, c_i64]
    lib.wr_convert_planes.argtypes = [f32p, f32p, f32p, c_i64]
    lib.wr_ring_new.restype = c_void
    lib.wr_ring_new.argtypes = [c_i64, c_int]
    lib.wr_ring_free.argtypes = [c_void]
    lib.wr_ring_push.argtypes = [c_void, f32p]
    lib.wr_ring_pop.restype = c_int
    lib.wr_ring_pop.argtypes = [c_void, f32p, c_i64]
    lib.wr_ring_close.argtypes = [c_void]
    for fn in ("wr_ring_dropped", "wr_ring_total", "wr_ring_depth_now"):
        getattr(lib, fn).restype = c_i64
        getattr(lib, fn).argtypes = [c_void]
    lib.wr_rtltcp_open.restype = c_void
    lib.wr_rtltcp_open.argtypes = [ctypes.c_char_p, c_int, c_i64, c_int]
    lib.wr_rtltcp_command.restype = c_int
    lib.wr_rtltcp_command.argtypes = [c_void, ctypes.c_uint8, ctypes.c_uint32]
    lib.wr_rtltcp_pop.restype = c_int
    lib.wr_rtltcp_pop.argtypes = [c_void, f32p, c_i64]
    lib.wr_rtltcp_dropped.restype = c_i64
    lib.wr_rtltcp_dropped.argtypes = [c_void]
    lib.wr_rtltcp_close.argtypes = [c_void]
    lib.wr_rtltcp_dongle_info.argtypes = [c_void, u32p, u32p]
    lib.wr_tone_open.restype = c_void
    lib.wr_tone_open.argtypes = [
        ctypes.c_double, c_i64, c_int, c_int, f64p, i32p, f64p,
        ctypes.c_double, ctypes.c_uint64,
    ]
    lib.wr_tone_pop.restype = c_int
    lib.wr_tone_pop.argtypes = [c_void, f32p, c_i64]
    lib.wr_tone_dropped.restype = c_i64
    lib.wr_tone_dropped.argtypes = [c_void]
    lib.wr_tone_close.argtypes = [c_void]
    return lib


def load(auto_build: bool = True):
    """Load (building if needed) and memoize the library; None where it is
    unavailable. A failed build or load is remembered: the callers that
    ask per block (``radio._to_planes``) never pay for a second attempt."""
    global _lib, _failed
    with _lib_lock:
        if _lib is not None or _failed:
            return _lib
        path = build() if auto_build else library_path()
        if path is None or not path.is_file():
            _failed = auto_build
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(path)))
        except (OSError, AttributeError) as e:
            log.warning("native library load failed: %s", e)
            _failed = True
        return _lib


def available() -> bool:
    return load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def convert_u8_iq(raw: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """u8 interleaved IQ -> float32 planes [2, N] ((x - 128) / 128,
    rtlsdrtuner.cxx:92-95), deinterleaved in native code."""
    lib = load()
    frames = len(raw) // 2
    if out is None:
        out = np.empty((2, frames), np.float32)
    raw = np.ascontiguousarray(raw, np.uint8)
    lib.wr_convert_u8_iq(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _f32p(out[0]), _f32p(out[1]), frames,
    )
    return out


def convert_planes(z: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """complex64 [N] -> float32 planes [2, N] in native code."""
    lib = load()
    frames = len(z)
    if out is None:
        out = np.empty((2, frames), np.float32)
    z = np.ascontiguousarray(z, np.complex64)
    lib.wr_convert_planes(
        z.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _f32p(out[0]), _f32p(out[1]), frames,
    )
    return out


class NativeRing:
    """Native fixed-block ring (drop-oldest, blocking pop) — the C++
    counterpart of :class:`webradio_tpu_torch.io.ring.BlockRing`, for
    ``[2, N]`` float32 plane blocks."""

    def __init__(self, frames: int, depth: int = 4):
        lib = load()
        if lib is None:
            raise RuntimeError("native ingest library unavailable")
        self._lib = lib
        self.frames = frames
        self._h = lib.wr_ring_new(2 * frames, depth)

    def push(self, planes: np.ndarray) -> None:
        self._lib.wr_ring_push(self._h, _f32p(np.ascontiguousarray(
            planes, np.float32)))

    def pop(self, timeout: float | None = None) -> np.ndarray | None:
        out = np.empty((2, self.frames), np.float32)
        ms = -1 if timeout is None else int(timeout * 1000)
        if self._lib.wr_ring_pop(self._h, _f32p(out), ms):
            return out
        return None

    def close(self) -> None:
        self._lib.wr_ring_close(self._h)

    @property
    def dropped_blocks(self) -> int:
        return self._lib.wr_ring_dropped(self._h)

    @property
    def total_blocks(self) -> int:
        return self._lib.wr_ring_total(self._h)

    def __del__(self):
        try:
            self._lib.wr_ring_free(self._h)
        except Exception:
            pass


class GuardedHandle:
    """A native handle whose calls may run in other threads while
    ``close`` is called: every native call on the handle goes through
    :meth:`_call`, which counts it as a reader; ``close`` marks the handle
    closed, waits until no reader is inside a native call, and only then
    frees the native object with ``close_fn(handle)``. A call after
    ``close`` does nothing and returns None. (The JAX package's
    ``NativeToneSource`` freed the session under a reader, and its
    soundcard source serialized read and close with a lock of its own;
    every native session of the port goes through this instead.)"""

    def __init__(self, handle, close_fn):
        self._h, self._close_fn = handle, close_fn
        self._cv = threading.Condition()
        self._readers = 0

    def _call(self, fn, *args):
        """``fn(handle, *args)`` while the handle cannot be freed; None
        once the handle is closed."""
        with self._cv:
            if self._h is None:
                return None
            self._readers += 1
            h = self._h
        try:
            return fn(h, *args)
        finally:
            with self._cv:
                self._readers -= 1
                self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            h, self._h = self._h, None
            while self._readers:
                self._cv.wait()
        if h:
            self._close_fn(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _Session(GuardedHandle):
    """A native capture session (a :class:`GuardedHandle`) that delivers
    ``[2, frames]`` float32 plane blocks; a ``pop`` waits at most
    :attr:`POP_SLICE_S` inside one native call, so ``close`` returns
    promptly."""

    #: longest single native wait of a pop, so close returns promptly
    POP_SLICE_S = 0.1

    def __init__(self, lib, handle, frames: int, pop_fn, close_fn):
        super().__init__(handle, close_fn)
        self._lib, self.frames, self._pop_fn = lib, int(frames), pop_fn

    def pop(self, timeout: float | None = None) -> np.ndarray | None:
        out = np.empty((2, self.frames), np.float32)
        left = timeout
        while True:
            wait = (self.POP_SLICE_S if left is None
                    else min(left, self.POP_SLICE_S))
            got = self._call(self._pop_fn, _f32p(out), int(wait * 1000))
            if got is None:
                return None
            if got:
                return out
            if left is not None:
                left -= wait
                if left <= 0:
                    return None


#: blocks a native capture session's ring holds before it drops the oldest
#: (683 ms at stock rates; the JAX package's sessions hold 4, the
#: reference's N_BUFFERS_LOG2=2). The ring is what keeps capturing while a
#: stretch holds the interpreter, so the Python capture thread cannot move
#: blocks on: the first ``/profile`` stop of a server held it 407-568 ms
#: on the H100 (PERF.md). The pump takes what the rings hold, so
#: steady-state latency does not change.
SESSION_RING_BLOCKS = 16


class NativeRtlTcp(_Session):
    """rtl_tcp capture session whose socket reader and conversion run in a
    C++ thread (no GIL traffic per block)."""

    CMD_FREQ = 0x01
    CMD_RATE = 0x02
    CMD_GAIN_MODE = 0x03
    CMD_GAIN = 0x04
    CMD_PPM = 0x05
    CMD_AGC = 0x08

    def __init__(self, host: str, port: int, frames: int,
                 depth: int = SESSION_RING_BLOCKS):
        lib = load()
        if lib is None:
            raise RuntimeError("native ingest library unavailable")
        h = lib.wr_rtltcp_open(host.encode(), port, frames, depth)
        if not h:
            raise ConnectionError(f"rtl_tcp connect failed: {host}:{port}")
        super().__init__(lib, h, frames, lib.wr_rtltcp_pop,
                         lib.wr_rtltcp_close)

    def command(self, op: int, arg: int) -> bool:
        return self._call(self._lib.wr_rtltcp_command, op,
                          arg & 0xFFFFFFFF) == 0

    def dongle_info(self) -> tuple[int, int]:
        """(tuner_type, gain_count) from the rtl_tcp connect header; (0, 0)
        once closed."""
        t, g = ctypes.c_uint32(0), ctypes.c_uint32(0)
        self._call(self._lib.wr_rtltcp_dongle_info, ctypes.byref(t),
                   ctypes.byref(g))
        return (t.value, g.value)

    @property
    def dropped_blocks(self) -> int:
        return self._call(self._lib.wr_rtltcp_dropped) or 0


class NativeTone(_Session):
    """Off-GIL synthetic-carrier session (``wr_tone_*``): a paced C++
    thread synthesizes the ToneSource carrier ensemble and fills a
    drop-oldest ring of ``[2, N]`` plane blocks."""

    KINDS = {"AM": 0, "FM": 1}

    def __init__(self, sample_rate: float, frames: int, carriers,
                 noise: float = 0.01, seed: int = 0,
                 depth: int = SESSION_RING_BLOCKS):
        lib = load()
        if lib is None:
            raise RuntimeError("native tone synthesizer unavailable")
        offs = np.ascontiguousarray([c[0] for c in carriers], np.float64)
        kinds = np.ascontiguousarray(
            [self.KINDS.get(c[1], 2) for c in carriers], np.int32)
        audio = np.ascontiguousarray([c[2] for c in carriers], np.float64)
        h = lib.wr_tone_open(
            float(sample_rate), int(frames), int(depth), len(carriers),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            audio.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            float(noise), int(seed) & 0xFFFFFFFFFFFFFFFF,
        )
        if not h:
            raise RuntimeError("wr_tone_open failed")
        super().__init__(lib, h, frames, lib.wr_tone_pop, lib.wr_tone_close)

    @property
    def dropped_blocks(self) -> int:
        return self._call(self._lib.wr_tone_dropped) or 0


if __name__ == "__main__":
    path = build()
    print("built:" if path else "build failed:", path or SOURCE)
