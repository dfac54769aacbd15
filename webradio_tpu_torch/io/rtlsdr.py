"""Direct-USB RTL-SDR driver: ctypes bindings to librtlsdr (the port's own
copy of ``webradio_tpu.io.rtlsdr``; numpy, ctypes and the standard library
only).

The reference's only hardware driver links librtlsdr and owns the dongle
directly (src/io/rtlsdrtuner.cxx): the constructor enumerates devices by
USB serial (rtlsdrtuner.cxx:45-55), ``init()`` opens by serial, reads the
crystal/USB identity strings, programs the sample rate and reads the
achieved rate back, enables the RTL2832 internal AGC, pushes cached
control settings and starts capture (rtlsdrtuner.cxx:185-248). Control
setters write through to the open device and fall back to caching when
closed (rtlsdrtuner.cxx:119-183), with live tuner-gain readback under AGC
(rtlsdrtuner.cxx:158-166).

This module is the same capability over ctypes: no compile-time
dependency, graceful absence when ``librtlsdr.so`` is not installed
(``rtlsdr_available()``), and the same open-by-serial / readback /
write-through semantics.

One deliberate difference from the JAX package: a tuner that has not
opened a dongle holds no placeholder source. The JAX tuner starts life over
a ``RandSource`` whose noise it serves until the dongle opens; here it
builds without hardware (a topology file can be checked anywhere), but its
source yields nothing, and ``start()`` returns False with the reason kept in
``error`` (and logged) where librtlsdr or the dongle is missing. Noise is
never served as if it were the dongle.

Capture is ASYNC like the reference's (rtlsdrtuner.cxx:65-117): a
dedicated reader thread sits in ``rtlsdr_read_async`` so USB bulk
transfers are continuously submitted — the RTL2832 only streams while a
transfer is pending, so any gap between synchronous reads silently drops
samples with no accounting. The C callback lands chunks in a bounded
byte queue (the analog of the reference's 4-slot ring); overruns there
are COUNTED and logged ("Lost N bytes", rtlsdrtuner.cxx:99-102) and
surface as ``lost_bytes`` in ``/status``. Block assembly happens on the
framework capture thread (io/ring.CaptureThread) feeding BlockRing as
before. Control setters write through WITHOUT queueing behind capture:
the reader thread never holds the device lock (librtlsdr control calls
are safe concurrent with async capture — the reference's setters write
through the same way, rtlsdrtuner.cxx:119-183), so a PUT
/tuners/.../control applies immediately instead of waiting out a 42.7 ms
blocking read. ``rtlsdr_read_sync`` remains as a fallback for librtlsdr
builds without the async API.

The u8 -> float conversion matches the reference: ``(x - 128) / 128``
(rtlsdrtuner.cxx:92-95).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import threading

import numpy as np

from .source import SampleSource
from .tuner import Tuner

log = logging.getLogger(__name__)


def _load_librtlsdr():
    name = ctypes.util.find_library("rtlsdr")
    if name:
        try:
            return ctypes.CDLL(name)
        except OSError:
            pass
    for path in ("librtlsdr.so.2", "librtlsdr.so.0", "librtlsdr.so"):
        try:
            return ctypes.CDLL(path)
        except OSError:
            continue
    return None


#: the loaded library, or None. Tests inject a fake here (and via
#: set_library) — the only seam the mocked unit tests need.
_LIB = _load_librtlsdr()

#: per-transfer USB buffer size handed to rtlsdr_read_async. librtlsdr's
#: default (16 * 32 KB x 15 transfers); ~9 callbacks/s at 2.4 Msps.
_ASYNC_BUF_BYTES = 262_144


def rtlsdr_available() -> bool:
    return _LIB is not None


def set_library(lib) -> None:
    """Inject a (fake) librtlsdr — the mock seam for hardware-free tests."""
    global _LIB
    _LIB = lib


def _prototypes(lib) -> None:
    """Declare restypes for pointer-returning functions (safe to call on
    fakes — missing attributes are simply skipped)."""
    for fn, restype in (
        ("rtlsdr_get_device_name", ctypes.c_char_p),
        ("rtlsdr_get_device_count", ctypes.c_uint32),
    ):
        if hasattr(lib, fn):
            try:
                getattr(lib, fn).restype = restype
            except (TypeError, AttributeError):
                pass


def list_devices() -> list[dict]:
    """Enumerate connected dongles: ``[{index, manufacturer, product,
    serial}]`` — the reference's constructor enumeration
    (rtlsdrtuner.cxx:45-55)."""
    if _LIB is None:
        return []
    _prototypes(_LIB)
    out = []
    for i in range(int(_LIB.rtlsdr_get_device_count())):
        mfg = ctypes.create_string_buffer(256)
        prod = ctypes.create_string_buffer(256)
        serial = ctypes.create_string_buffer(256)
        if _LIB.rtlsdr_get_device_usb_strings(i, mfg, prod, serial) == 0:
            out.append(
                {
                    "index": i,
                    "manufacturer": mfg.value.decode(errors="replace"),
                    "product": prod.value.decode(errors="replace"),
                    "serial": serial.value.decode(errors="replace"),
                }
            )
    return out


#: librtlsdr async read callback: (unsigned char *buf, uint32_t len, void *ctx)
_READ_ASYNC_CB = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_uint32, ctypes.c_void_p
)


class _ChunkQueue:
    """Bounded byte-chunk queue between the USB callback and block
    assembly — the reference's 4-slot capture ring with its "Lost N
    bytes" overrun accounting (rtlsdrtuner.cxx:33-34,99-102). Overflow
    drops OLDEST (the live edge matters) and counts the lost bytes."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self.lost_bytes = 0
        self._chunks: list[bytes] = []
        self._size = 0
        self._cv = threading.Condition()
        self._closed = False

    def push(self, data: bytes) -> None:
        with self._cv:
            if self._closed:
                return
            lost = 0
            while self._size + len(data) > self.max_bytes and self._chunks:
                dropped = self._chunks.pop(0)
                self._size -= len(dropped)
                lost += len(dropped)
            if lost:
                self.lost_bytes += lost
                log.warning("rtlsdr: lost %d bytes (capture overrun, "
                            "%d total)", lost, self.lost_bytes)
            self._chunks.append(data)
            self._size += len(data)
            self._cv.notify()

    def pop_exact(self, n: int, timeout: float = 2.0) -> bytes | None:
        """Assemble exactly ``n`` bytes; None once closed and drained or
        on timeout. A timeout loses nothing: the partial assembly is
        returned to the queue head, so the NEXT call resumes
        byte-continuous (a transient USB stall must not shear the IQ
        stream)."""
        out = bytearray()
        deadline = None
        with self._cv:
            while len(out) < n:
                if self._chunks:
                    chunk = self._chunks.pop(0)
                    self._size -= len(chunk)
                    take = n - len(out)
                    out += chunk[:take]
                    if len(chunk) > take:
                        # return the remainder to the queue head
                        self._chunks.insert(0, chunk[take:])
                        self._size += len(chunk) - take
                    continue
                if self._closed:
                    return None
                import time as _time

                if deadline is None:
                    deadline = _time.monotonic() + timeout
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    if out:  # keep the partial for the next call
                        self._chunks.insert(0, bytes(out))
                        self._size += len(out)
                    return None
                self._cv.wait(remaining)
        return bytes(out)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed


class _AsyncReader(threading.Thread):
    """Owns the blocking ``rtlsdr_read_async`` session.

    librtlsdr keeps ~15 USB bulk transfers continuously submitted while
    this call runs, which is what keeps the RTL2832 streaming without
    gaps; the callback copies each buffer into the chunk queue. The
    session ends via ``rtlsdr_cancel_async`` (stop) or device loss
    (read_async returns on its own) — either way the queue is closed so
    the block assembler sees end-of-stream."""

    def __init__(self, dev, chunks: _ChunkQueue, buf_bytes: int,
                 name: str = "rtlsdr-usb"):
        super().__init__(daemon=True, name=name)
        self._dev = dev
        self._chunks = chunks
        self._buf_bytes = int(buf_bytes)
        self.rc = None

        def on_samples(buf, length, _ctx):
            try:
                self._chunks.push(ctypes.string_at(buf, length))
            except Exception:  # never let an exception cross into C
                log.debug("rtlsdr: async callback failed", exc_info=True)

        # the CFUNCTYPE object must outlive the session (held on self)
        self._cb = _READ_ASYNC_CB(on_samples)

    def run(self) -> None:
        try:
            self.rc = _LIB.rtlsdr_read_async(
                self._dev, self._cb, None, 0, self._buf_bytes
            )
        except Exception:
            log.exception("rtlsdr: read_async failed")
            self.rc = -1
        finally:
            # stop() closed us intentionally, or the device vanished —
            # both end the stream for the block assembler
            self._chunks.close()


class _RtlSdrAsyncSource(SampleSource):
    """Block assembly from the async chunk queue (the preferred path)."""

    #: consecutive assembly timeouts tolerated while the USB reader is
    #: still alive (same transient tolerance as the sync path's
    #: MAX_CONSECUTIVE_FAILURES — a hub reset or transfer restart must
    #: not end capture permanently)
    MAX_CONSECUTIVE_TIMEOUTS = 10

    def __init__(self, tuner: "RtlSdrTuner"):
        super().__init__()
        self._tuner = tuner
        self._timeout_count = 0

    def read_block(self) -> np.ndarray | None:
        chunks = self._tuner._chunks
        if chunks is None:
            return None
        raw = chunks.pop_exact(self.block_frames * 2,
                               timeout=max(2.0, 4 * self.block_frames
                                           / max(1, self.sample_rate)))
        if raw is None:
            if self._tuner._closing or chunks.closed:
                return None  # intentional stop / queue closed
            reader = self._tuner._reader
            if reader is not None and not reader.is_alive():
                log.error("rtlsdr: device stream ended (rc=%s)", reader.rc)
                return None  # genuine device loss
            # transient stall with a live reader: keep streaming (the
            # partial assembly stayed queued, so no bytes are lost)
            self._timeout_count += 1
            log.warning("rtlsdr: no samples for a block period (%d "
                        "consecutive)", self._timeout_count)
            if self._timeout_count >= self.MAX_CONSECUTIVE_TIMEOUTS:
                log.error("rtlsdr: %d consecutive stalls; ending capture",
                          self._timeout_count)
                return None
            return self._counted(np.zeros(self.block_frames, np.complex64))
        self._timeout_count = 0
        # the chunk queue drops bytes, not blocks: whole blocks' worth of
        # them count in the index
        return self._counted(_u8_to_complex(raw), self._tuner.lost_bytes
                             // (2 * self.block_frames))


def _u8_to_complex(raw: bytes) -> np.ndarray:
    """``(x - 128) / 128`` interleaved u8 -> complex64
    (rtlsdrtuner.cxx:92-95)."""
    f = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
         - 128.0) / 128.0
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


class _RtlSdrSource(SampleSource):
    """Blocking block reads via ``rtlsdr_read_sync`` — the FALLBACK for
    librtlsdr builds without the async API.

    Runs on the framework capture thread (io/ring.CaptureThread);
    backpressure is the BlockRing's drop-with-log. Note the async path
    is strictly better: between sync reads the dongle has no submitted
    transfer and silently drops samples with no accounting."""

    #: consecutive failed reads tolerated before declaring end-of-stream
    #: (the reference's async model logs overruns and keeps streaming,
    #: rtlsdrtuner.cxx:99-102; one USB hiccup must not kill capture)
    MAX_CONSECUTIVE_FAILURES = 10

    def __init__(self, tuner: "RtlSdrTuner"):
        super().__init__()
        self._tuner = tuner
        self._fail_count = 0

    def read_block(self) -> np.ndarray | None:
        need = self.block_frames * 2
        buf = ctypes.create_string_buffer(need)
        n_read = ctypes.c_int(0)
        # the device handle is checked and used UNDER the tuner's device
        # lock: stop() and every control setter take the same lock, so
        # the handle can never be freed (or written) while a synchronous
        # USB transfer is in flight (close-during-read is native UB)
        with self._tuner._dev_lock:
            dev = self._tuner._dev
            if dev is None or self._tuner._closing:
                return None
            rc = _LIB.rtlsdr_read_sync(dev, buf, need,
                                       ctypes.byref(n_read))
        if rc != 0 or n_read.value < need:
            self._fail_count += 1
            log.warning("rtlsdr: short read (%d of %d bytes, rc=%d, "
                        "%d consecutive)", n_read.value, need, rc,
                        self._fail_count)
            if self._fail_count >= self.MAX_CONSECUTIVE_FAILURES:
                log.error("rtlsdr: %d consecutive read failures; "
                          "ending capture", self._fail_count)
                return None  # genuine device loss -> end of stream
            # transient hiccup: emit one silent block and keep streaming
            return self._counted(np.zeros(self.block_frames, np.complex64))
        self._fail_count = 0
        return self._counted(_u8_to_complex(buf.raw))


class _NoDongle(SampleSource):
    """The source of a tuner whose dongle is not open: it yields no block
    (end of stream), where the JAX package's placeholder yields noise."""

    def start(self) -> bool:
        return False

    def read_block(self) -> np.ndarray | None:
        return None


class RtlSdrTuner(Tuner):
    """RTL2832U dongle over direct USB (librtlsdr), subdevice = serial.

    ``subdevice`` selects the dongle by USB serial string (empty = first
    device), mirroring the reference's open-by-serial
    (rtlsdrtuner.cxx:185-200 via rtlsdr_get_index_by_serial). Control
    setters write through when the device is open and cache otherwise
    (rtlsdrtuner.cxx:119-183).
    """

    driver = "rtlsdr"

    def __init__(self, subdevice: str = ""):
        self._dev = None
        self._closing = False
        #: serializes EVERY librtlsdr call on this handle: the blocking
        #: block read, the write-through control setters (invoked from
        #: HTTP threads), gain readback, and close — librtlsdr handles
        #: are not thread-safe, and a close racing any call is a
        #: use-after-free
        self._dev_lock = threading.RLock()
        self._requested_serial = subdevice
        self._chunks: _ChunkQueue | None = None
        self._reader: _AsyncReader | None = None
        self.xtal_hz = 0
        self.tuner_xtal_hz = 0
        #: why the last start() failed, or None
        self.error: str | None = None
        super().__init__(_NoDongle(), name="RTL-SDR USB dongle")
        self.product = "rtlsdr"
        self.serial = subdevice
        self.subdevices = list_devices()

    # ---- open/close --------------------------------------------------
    def _fail(self, reason: str) -> bool:
        self.error = reason
        log.error("rtlsdr: %s", reason)
        return False

    def _open(self) -> bool:
        if _LIB is None:
            return self._fail("librtlsdr not available")
        _prototypes(_LIB)
        if self._requested_serial:
            index = _LIB.rtlsdr_get_index_by_serial(
                self._requested_serial.encode()
            )
            if index < 0:
                return self._fail(f"no device with serial "
                                  f"{self._requested_serial!r} (rc={index})")
        else:
            if int(_LIB.rtlsdr_get_device_count()) == 0:
                return self._fail("no devices found")
            index = 0
        dev = ctypes.c_void_p()
        rc = _LIB.rtlsdr_open(ctypes.byref(dev), index)
        if rc != 0 or not dev:
            return self._fail(f"open failed (rc={rc})")
        self._dev = dev

        # identity + crystal readback (rtlsdrtuner.cxx:205-222)
        rtl_xtal = ctypes.c_uint32(0)
        tuner_xtal = ctypes.c_uint32(0)
        if hasattr(_LIB, "rtlsdr_get_xtal_freq"):
            _LIB.rtlsdr_get_xtal_freq(dev, ctypes.byref(rtl_xtal),
                                      ctypes.byref(tuner_xtal))
        self.xtal_hz = int(rtl_xtal.value)
        self.tuner_xtal_hz = int(tuner_xtal.value)
        mfg = ctypes.create_string_buffer(256)
        prod = ctypes.create_string_buffer(256)
        serial = ctypes.create_string_buffer(256)
        if _LIB.rtlsdr_get_usb_strings(dev, mfg, prod, serial) == 0:
            self.manufacturer = mfg.value.decode(errors="replace")
            self.product = prod.value.decode(errors="replace")
            self.serial = serial.value.decode(errors="replace")
        return True

    def _close(self) -> None:
        if self._dev is not None:
            _LIB.rtlsdr_close(self._dev)
            self._dev = None

    # ---- lifecycle ---------------------------------------------------
    def start(self) -> bool:
        with self._dev_lock:  # RLock: the setters below re-enter it
            if self._dev is None and not self._open():
                return False
            self.error = None
            dev = self._dev
            # program + read back the achieved rate (rtlsdrtuner.cxx:226-228)
            _LIB.rtlsdr_set_sample_rate(dev, int(self.source.sample_rate))
            self._achieved_rate = int(_LIB.rtlsdr_get_sample_rate(dev))
            # RTL2832 internal (digital) AGC always on, as the reference
            # chooses (rtlsdrtuner.cxx:229)
            _LIB.rtlsdr_set_agc_mode(dev, 1)
            # push cached control state (rtlsdrtuner.cxx:232-235)
            self.set_centre_frequency(self._centre_frequency)
            self.set_offset_ppm(self._offset_ppm)
            self.set_agc(self._agc)
            if not self._agc:
                self.set_gain_db(self._gain_db)
            _LIB.rtlsdr_reset_buffer(dev)
        old = self.source
        if hasattr(_LIB, "rtlsdr_read_async"):
            # preferred: continuous USB transfers + in-driver loss
            # accounting (module docstring; rtlsdrtuner.cxx:65-117)
            src = _RtlSdrAsyncSource(self)
            src.sample_rate = old.sample_rate
            src.block_frames = old.block_frames
            # capacity = the reference's 4-block stall tolerance
            # (rtlsdrtuner.cxx:33-34), in bytes of interleaved u8 IQ
            self._chunks = _ChunkQueue(
                max_bytes=max(4 * src.block_frames * 2, 1 << 20)
            )
            self._reader = _AsyncReader(
                self._dev, self._chunks,
                buf_bytes=_ASYNC_BUF_BYTES,
                name=f"rtlsdr-usb-{self.serial or 'dev0'}",
            )
            self._reader.start()
        else:
            src = _RtlSdrSource(self)
            src.sample_rate = old.sample_rate
            src.block_frames = old.block_frames
        self.source = src
        return self.source.start()

    def stop(self) -> None:
        # sequence: flag the capture loop off, cancel the async session
        # and JOIN the reader (the reference cancels its async reader and
        # joins before closing, rtlsdrtuner.cxx:253-263), stop the
        # source, then close the device UNDER the device lock — so the
        # handle is never freed while any librtlsdr call is in flight
        self._closing = True
        try:
            reader, self._reader = self._reader, None
            if reader is not None and self._dev is not None:
                # cancel can race read_async's startup; retry until the
                # reader leaves the C call
                for _ in range(25):
                    try:
                        _LIB.rtlsdr_cancel_async(self._dev)
                    except Exception:
                        break
                    reader.join(timeout=0.2)
                    if not reader.is_alive():
                        break
                if reader.is_alive():
                    log.warning("rtlsdr: async reader did not exit; "
                                "leaving device open (leak over UAF)")
                    self._closing = False
                    super().stop()
                    return
            if self._chunks is not None:
                self._chunks.close()
                self._chunks = None
            super().stop()
            with self._dev_lock:
                self._close()
        finally:
            self._closing = False

    @property
    def lost_bytes(self) -> int:
        """Driver-level capture overrun accounting (the reference's
        "Lost N bytes" counter, rtlsdrtuner.cxx:99-102)."""
        chunks = self._chunks
        return chunks.lost_bytes if chunks is not None else 0

    # ---- readback ----------------------------------------------------
    @property
    def effective_sample_rate(self) -> int:
        """The device's achieved rate (rtlsdr_get_sample_rate readback,
        rtlsdrtuner.cxx:226-228); the request until the device opens."""
        rate = getattr(self, "_achieved_rate", 0)
        return rate if rate else int(self.source.sample_rate)

    @property
    def gain_db(self) -> float:
        """Live tuner-gain readback when open (what AGC actually chose —
        rtlsdrtuner.cxx:158-166); the cached setting when closed."""
        with self._dev_lock:
            if (self._dev is not None
                    and hasattr(_LIB, "rtlsdr_get_tuner_gain")):
                tenths = int(_LIB.rtlsdr_get_tuner_gain(self._dev))
                if tenths != 0 or self._agc:
                    return tenths / 10.0
        return self._gain_db

    def supported_gains_db(self) -> list[float]:
        """The dongle's gain table (rtlsdr_get_tuner_gains)."""
        with self._dev_lock:
            if (self._dev is None
                    or not hasattr(_LIB, "rtlsdr_get_tuner_gains")):
                return []
            n = int(_LIB.rtlsdr_get_tuner_gains(self._dev, None))
            if n <= 0:
                return []
            buf = (ctypes.c_int * n)()
            _LIB.rtlsdr_get_tuner_gains(self._dev, buf)
        return [g / 10.0 for g in buf]

    # ---- control write-through (rtlsdrtuner.cxx:119-183), each call
    # under the device lock so a concurrent stop() can never free the
    # handle mid-write (the setters run on HTTP threads)
    def set_centre_frequency(self, hz: int) -> None:
        super().set_centre_frequency(hz)
        with self._dev_lock:
            if self._dev is not None:
                _LIB.rtlsdr_set_center_freq(self._dev, int(hz))

    def set_offset_ppm(self, ppm: int) -> None:
        super().set_offset_ppm(ppm)
        with self._dev_lock:
            if self._dev is not None:
                # librtlsdr returns -2 for "already at this correction";
                # harmless, matching the reference's unchecked call
                _LIB.rtlsdr_set_freq_correction(self._dev, int(ppm))

    def set_agc(self, on: bool) -> None:
        super().set_agc(on)
        with self._dev_lock:
            if self._dev is not None:
                _LIB.rtlsdr_set_tuner_gain_mode(self._dev, 0 if on else 1)
                if not on:
                    _LIB.rtlsdr_set_tuner_gain(
                        self._dev, int(round(self._gain_db * 10))
                    )

    def set_gain_db(self, db: float) -> None:
        super().set_gain_db(db)
        with self._dev_lock:
            if self._dev is not None and not self._agc:
                _LIB.rtlsdr_set_tuner_gain(self._dev,
                                           int(round(db * 10)))
