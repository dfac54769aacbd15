"""Sample sources: fixed-size IQ block producers (the port's own copy of
``webradio_tpu.io.source``; :class:`NativeToneSource` synthesizes in the
port's native ingest library, ``io/native.py``).

The reference's ``SampleSource`` hierarchy (src/io/samplesource.h) couples
sample production with the pull-through pipeline; here sources are plain
iterables of ``[block_frames]`` complex64 NumPy blocks consumed by the ingest
ring. Subdevice enumeration/selection survives as a light protocol
(samplesource.h:54-58 semantics: selectable only while stopped).
"""

from __future__ import annotations

import abc
import pathlib
import time

import numpy as np


class SampleSource(abc.ABC):
    """Produces fixed-size complex64 IQ blocks at a nominal sample rate."""

    def __init__(self):
        self._subdevices: list[str] = []
        self._subdevice: str = ""
        self._running = False
        self.sample_rate: int = 1_200_000  # tuner.h:33 default
        self.block_frames: int = 16_384 // 2  # dspblock.h:41 default / 2 ch

    @property
    def subdevices(self) -> list[str]:
        return list(self._subdevices)

    @property
    def subdevice(self) -> str:
        return self._subdevice

    def set_subdevice(self, name: str) -> bool:
        if self._running:
            return False  # samplesource.h:54-58: only when stopped
        self._subdevice = name
        return True

    def start(self) -> bool:
        self._running = True
        return True

    def stop(self) -> None:
        self._running = False

    @abc.abstractmethod
    def read_block(self) -> np.ndarray | None:
        """Return the next ``[block_frames]`` complex64 block, or None at
        end-of-stream. May block (hardware cadence)."""

    # ---- real-time pacing for non-hardware sources -------------------
    # Hardware sources are paced by the device DMA (the reference blocks on
    # the USB ring, rtlsdrtuner.cxx:265-285). Synthetic/replay sources call
    # ``_pace()`` per block so live streaming runs at signal rate; set
    # ``realtime = False`` for offline benchmarking.
    realtime: bool = True

    def _pace(self) -> None:
        if not self.realtime:
            return
        now = time.monotonic()
        t0 = getattr(self, "_pace_t0", None)
        if t0 is None:
            self._pace_t0 = now
            self._pace_blocks = 0
            return
        self._pace_blocks += 1
        deadline = t0 + self._pace_blocks * self.block_frames / self.sample_rate
        delay = deadline - now
        if delay > 0:
            time.sleep(delay)
        elif delay < -1.0:
            # fell far behind (e.g. suspended) — resynchronize instead of
            # producing a burst
            self._pace_t0 = now
            self._pace_blocks = 0


class RandSource(SampleSource):
    """White-noise test source: uniform in [-1, 1) on both I and Q
    (src/io/randsource.cxx:52-58)."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self._rng = np.random.default_rng(seed)

    def read_block(self) -> np.ndarray:
        self._pace()
        i = self._rng.uniform(-1, 1, self.block_frames).astype(np.float32)
        q = self._rng.uniform(-1, 1, self.block_frames).astype(np.float32)
        return (i + 1j * q).astype(np.complex64)


class ToneSource(SampleSource):
    """Synthetic multi-carrier source for tests and demos (no reference
    analog; the seam RandSource provides, made useful): a set of AM/FM
    carriers at given IF offsets, phase-continuous across blocks."""

    #: default ensemble: an AM carrier on centre (audible with the stock
    #: IF-0 AM receiver, main.cxx:82-83) plus an FM carrier at +100 kHz
    #: (the reference's #if 0'd second receiver, main.cxx:85-90)
    DEFAULT_CARRIERS = (
        (0.0, "AM", 1_000.0),
        (100_000.0, "FM", 440.0),
    )

    def __init__(self, carriers=DEFAULT_CARRIERS, noise: float = 0.01,
                 seed: int = 0):
        super().__init__()
        self.carriers = list(carriers)  # (offset_hz, kind, audio_hz)
        self.noise = noise
        self._rng = np.random.default_rng(seed)
        self._n0 = 0

    def read_block(self) -> np.ndarray:
        self._pace()
        # float32 synthesis: the capture thread shares the GIL with the
        # block pump, so keep generation cheap (~2 ms/42.7 ms block instead
        # of ~18 ms with complex128 exp)
        n = np.arange(self._n0, self._n0 + self.block_frames, dtype=np.float64)
        t = (n / self.sample_rate)
        re = np.zeros(self.block_frames, np.float32)
        im = np.zeros(self.block_frames, np.float32)
        two_pi = 2 * np.pi
        for offset, kind, audio_hz in self.carriers:
            if kind == "FM":
                # 5 kHz deviation NBFM, closed-form phase integral
                # phi(t) = 2*pi*f0*t + 2*pi*D int sin(2*pi*fa*tau) dtau
                #        = 2*pi*f0*t - (D/fa) cos(2*pi*fa*t), D = 5 kHz
                theta = np.mod(
                    two_pi * offset * t
                    - 5_000.0 / audio_hz * np.cos(two_pi * audio_hz * t),
                    two_pi,
                ).astype(np.float32)  # wrap in f64, then narrow
                re += np.cos(theta)
                im += np.sin(theta)
            else:
                theta = np.mod(two_pi * offset * t, two_pi).astype(np.float32)
                if kind == "AM":
                    env = (
                        1.0 + 0.5 * np.sin(two_pi * audio_hz * t)
                    ).astype(np.float32)
                else:
                    env = np.float32(1.0)
                re += env * np.cos(theta)
                im += env * np.sin(theta)
        z = np.empty(self.block_frames, np.complex64)
        z.real = re
        z.imag = im
        if self.noise:
            z += (self.noise * (
                self._rng.standard_normal(self.block_frames)
                + 1j * self._rng.standard_normal(self.block_frames)
            )).astype(np.complex64)
        self._n0 += self.block_frames
        return z / max(1, len(self.carriers))


class NativeToneSource(SampleSource):
    """Off-GIL :class:`ToneSource`: the same carrier ensemble synthesized by
    a paced C++ thread (``native/src/ingest.cpp`` ``wr_tone_*``), delivered
    as ready ``[2, N]`` float32 plane blocks. The numpy source holds the
    GIL while it synthesizes; this one costs the pump nothing, like a
    hardware capture path (rtlsdrtuner.cxx:86-117).

    :meth:`stop` may run while another thread waits in :meth:`read_block`:
    the session frees its native object only after the reader has left
    the native call (:class:`.native.NativeTone`), and the reader then
    returns None."""

    def __init__(self, carriers=None, noise: float = 0.01, seed: int = 0):
        super().__init__()
        self.carriers = list(carriers if carriers is not None
                             else ToneSource.DEFAULT_CARRIERS)
        self.noise = noise
        self.seed = seed
        self._session = None

    def start(self) -> bool:
        from . import native

        if not native.available():
            return False
        try:
            self._session = native.NativeTone(
                self.sample_rate, self.block_frames, self.carriers,
                self.noise, self.seed,
            )
        except RuntimeError:
            return False
        return super().start()

    def stop(self) -> None:
        super().stop()
        session, self._session = self._session, None
        if session is not None:
            session.close()

    @property
    def dropped_blocks(self) -> int:
        """Blocks the native ring dropped because no reader took them."""
        session = self._session
        return session.dropped_blocks if session is not None else 0

    def read_block(self) -> np.ndarray | None:
        while self._running:
            session = self._session
            if session is None:
                return None
            out = session.pop(timeout=1.0)
            if out is not None:
                return out
        return None


class FileSource(SampleSource):
    """Replay a recorded IQ capture.

    Formats (by extension): ``.npy`` (complex64 or float32 [N,2]), ``.cu8``
    / ``.bin`` (interleaved u8 as produced by rtl_sdr: (x-128)/128 like
    rtlsdrtuner.cxx:92-95), ``.cf32`` (interleaved float32 IQ). Loops by
    default so live demos never starve.
    """

    def __init__(self, path: str | pathlib.Path, loop: bool = True):
        super().__init__()
        self.path = pathlib.Path(path)
        self.loop = loop
        self._data = self._load(self.path)
        self._pos = 0
        self._subdevices = [str(self.path)]
        self._subdevice = str(self.path)

    @staticmethod
    def _load(path: pathlib.Path) -> np.ndarray:
        ext = path.suffix.lower()
        if ext == ".npy":
            arr = np.load(path)
            if arr.ndim == 2 and arr.shape[1] == 2:
                arr = arr[:, 0] + 1j * arr[:, 1]
            return arr.astype(np.complex64)
        raw = np.fromfile(path, dtype=np.uint8 if ext in (".cu8", ".bin") else np.float32)
        if ext in (".cu8", ".bin"):
            f = (raw.astype(np.float32) - 128.0) / 128.0  # rtlsdrtuner.cxx:94
        else:
            f = raw.astype(np.float32)
        f = f[: (len(f) // 2) * 2].reshape(-1, 2)
        return (f[:, 0] + 1j * f[:, 1]).astype(np.complex64)

    def read_block(self) -> np.ndarray | None:
        self._pace()
        n = self.block_frames
        total = len(self._data)
        if self._pos + n <= total:
            out = self._data[self._pos : self._pos + n]
            self._pos += n
            return out
        if not self.loop:
            return None
        parts = [self._data[self._pos :]]
        need = n - len(parts[0])
        while need >= total:
            parts.append(self._data)
            need -= total
        parts.append(self._data[:need])
        self._pos = need
        return np.concatenate(parts)
