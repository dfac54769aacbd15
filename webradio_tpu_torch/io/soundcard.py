"""Local soundcard audio I/O (the port's own copy of
``webradio_tpu.io.soundcard``; numpy, ctypes and the standard library
only).

The reference ships ``PulseAudioSource``/``PulseAudioSink`` over the
blocking "simple" API at FLOAT32LE (src/io/pulseaudio.cxx:39-42,60-92,
113-152), compiled in but unused by ``main()`` (the server streams over
HTTP instead). Equivalent here:

* :class:`PulseAudioSink` / :class:`PulseAudioSource` — ctypes bindings to
  ``libpulse-simple`` with the same format and blocking semantics; gated on
  the library's presence (``pulse_available()``), since server deployments
  have no sound stack. The library is looked up at first use, not when the
  module is imported.
* :class:`SoundcardIQSource` — stereo line-in carrying I/Q, the
  ``"soundcard"`` tuner driver's source.
* :class:`FileAudioSink` — always available: stream PCM (or WAV) to a
  path or FIFO, the headless stand-in used by tests and recordings.

Every call on an open stream goes through a :class:`.native.GuardedHandle`,
so ``pa_simple_free`` never runs while another thread is inside
``pa_simple_read`` or ``pa_simple_write`` on the same stream.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import pathlib
import struct
import threading

import numpy as np

from .native import GuardedHandle
from .source import SampleSource

log = logging.getLogger(__name__)

_PA_STREAM_PLAYBACK = 1
_PA_STREAM_RECORD = 2
_PA_SAMPLE_FLOAT32LE = 5  # pulseaudio.cxx:39 FLOAT32LE

#: the loaded libpulse-simple, None where it is missing, or _UNLOADED until
#: the first use looks it up (tests put a stand-in here)
_UNLOADED = object()
_PA = _UNLOADED
_pa_lock = threading.Lock()


def _load_pulse():
    for name in ("pulse-simple", "pulse-simple.0"):
        path = ctypes.util.find_library(name)
        if path:
            try:
                return ctypes.CDLL(path)
            except OSError:
                continue
    for path in ("libpulse-simple.so.0", "libpulse-simple.so"):
        try:
            return ctypes.CDLL(path)
        except OSError:
            continue
    return None


def _lib():
    """libpulse-simple, looked up once; None where it is missing."""
    global _PA
    with _pa_lock:
        if _PA is _UNLOADED:
            _PA = _load_pulse()
        return _PA


def pulse_available() -> bool:
    return _lib() is not None


class _SampleSpec(ctypes.Structure):
    _fields_ = [
        ("format", ctypes.c_int),
        ("rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint8),
    ]


def _prototypes(pa) -> None:
    vp, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    pa.pa_simple_new.restype = vp
    pa.pa_simple_new.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.POINTER(_SampleSpec), vp, vp, ip]
    for name in ("pa_simple_read", "pa_simple_write"):
        getattr(pa, name).restype = ctypes.c_int
        getattr(pa, name).argtypes = [vp, vp, ctypes.c_size_t, ip]
    pa.pa_simple_free.restype = None
    pa.pa_simple_free.argtypes = [vp]


class _PulseSimple(GuardedHandle):
    """Open/close over pa_simple (pulseaudio.cxx:60-81): the stream handle
    is a :class:`GuardedHandle`, freed by ``pa_simple_free`` only once no
    thread is inside a call on it."""

    def __init__(self, direction: int, sample_rate: int, channels: int,
                 device: str | None, name: str, stream: str):
        pa = _lib()
        if pa is None:
            raise RuntimeError("libpulse-simple not available")
        _prototypes(pa)
        spec = _SampleSpec(_PA_SAMPLE_FLOAT32LE, sample_rate, channels)
        err = ctypes.c_int(0)
        handle = pa.pa_simple_new(
            None, name.encode(), direction,
            device.encode() if device else None,
            stream.encode(), ctypes.byref(spec), None, None,
            ctypes.byref(err),
        )
        if not handle:
            raise RuntimeError(f"pa_simple_new failed (err {err.value})")
        super().__init__(ctypes.c_void_p(handle), pa.pa_simple_free)
        self._pa = pa
        self.sample_rate = sample_rate
        self.channels = channels

    def _transfer(self, fn, data: np.ndarray) -> bool:
        """One blocking ``pa_simple_read``/``pa_simple_write`` of all of
        ``data``; False on an error or once closed."""
        err = ctypes.c_int(0)
        rc = self._call(fn, data.ctypes.data_as(ctypes.c_void_p),
                        data.nbytes, ctypes.byref(err))
        return rc == 0


class PulseAudioSink(_PulseSimple):
    """Blocking playback of float32 mono/stereo audio
    (pulseaudio.cxx:113-152)."""

    def __init__(self, sample_rate: int = 48_000, channels: int = 1,
                 device: str | None = None):
        super().__init__(_PA_STREAM_PLAYBACK, sample_rate, channels, device,
                         "webradio-tpu", "audio out")

    def write(self, samples: np.ndarray) -> bool:
        return self._transfer(self._pa.pa_simple_write,
                              np.ascontiguousarray(samples, np.float32))


class PulseAudioSource(_PulseSimple):
    """Blocking capture of float32 audio (pulseaudio.cxx:83-92)."""

    def __init__(self, sample_rate: int = 48_000, channels: int = 1,
                 device: str | None = None):
        super().__init__(_PA_STREAM_RECORD, sample_rate, channels, device,
                         "webradio-tpu", "audio in")

    def read(self, frames: int) -> np.ndarray | None:
        out = np.empty(frames * self.channels, np.float32)
        return out if self._transfer(self._pa.pa_simple_read, out) else None


class SoundcardIQSource(SampleSource):
    """Stereo line-in I/Q capture: the reference's ``PulseAudioSource``
    (pulseaudio.cxx:83-92) made a usable front-end seam.

    A direct-conversion front end (soft-rock style receiver) delivers
    I/Q on the left/right channels of a soundcard; this source captures
    2-channel FLOAT32LE via the blocking simple API and yields ``[2, N]``
    float32 planes. Pacing comes from the soundcard clock itself —
    ``pa_simple_read`` blocks until the frames exist, exactly the
    reference's source contract (its ``process()`` is a blocking read).
    ``device`` is the PulseAudio source device name (samplesource.h
    subdevice semantics). :meth:`stop` may run while another thread waits
    in :meth:`read_block`: the stream is freed only after that read has
    returned, and the reader then gets None. Where the stream cannot open,
    :meth:`start` returns False with the reason in :attr:`error`."""

    def __init__(self, device: str = ""):
        super().__init__()
        self._subdevice = device
        self.sample_rate = 96_000  # typical soundcard-SDR line-in rate
        self._pa: PulseAudioSource | None = None
        #: why the last start() failed, or None
        self.error: str | None = None

    def start(self) -> bool:
        if not pulse_available():
            return self._fail("libpulse-simple not found")
        try:
            self._pa = PulseAudioSource(self.sample_rate, 2,
                                        self._subdevice or None)
        except RuntimeError as e:
            return self._fail(f"failed to open: {e}")
        self.error = None
        return super().start()

    def _fail(self, reason: str) -> bool:
        self.error = f"soundcard capture unavailable: {reason}"
        log.error("%s", self.error)
        return False

    def stop(self) -> None:
        super().stop()
        pa, self._pa = self._pa, None
        if pa is not None:
            pa.close()

    def read_block(self) -> np.ndarray | None:
        pa = self._pa
        if pa is None:
            return None
        data = pa.read(self.block_frames)
        if data is None:
            return None
        # interleaved LRLR float32 -> [2, N] I/Q planes (the pump's
        # native-plane path, radio._to_planes)
        return np.ascontiguousarray(data.reshape(-1, 2).T)


class FileAudioSink:
    """Headless audio sink: raw float32/PCM16/WAV to a file or FIFO."""

    def __init__(self, path: str | pathlib.Path, sample_rate: int = 48_000,
                 channels: int = 1, fmt: str = "wav"):
        self.path = pathlib.Path(path)
        self.sample_rate = sample_rate
        self.channels = channels
        self.fmt = fmt
        self._f = open(self.path, "wb")
        self._frames = 0
        if fmt == "wav":
            self._f.write(self._wav_header(0xFFFFFFFF))

    def _wav_header(self, length: int) -> bytes:
        sr, ch = self.sample_rate, self.channels
        return (b"RIFF" + struct.pack("<I", length) + b"WAVE"
                + b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, sr,
                                        sr * ch * 2, ch * 2, 16)
                + b"data" + struct.pack("<I", length))

    def write(self, samples: np.ndarray) -> bool:
        x = np.asarray(samples, np.float32).reshape(-1)
        if self.fmt == "f32":
            data = x.tobytes()
        else:
            data = (np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
        self._f.write(data)
        self._frames += len(x) // self.channels
        return True

    def close(self) -> None:
        if self._f.closed:
            return
        if self.fmt == "wav" and self._f.seekable():
            # patch real lengths for finite recordings
            bytes_ = self._frames * self.channels * 2
            self._f.seek(0)
            self._f.write(self._wav_header(36 + bytes_)[:8])
            self._f.seek(40)
            self._f.write(struct.pack("<I", bytes_))
        self._f.close()
