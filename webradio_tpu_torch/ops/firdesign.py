"""FIR coefficient design (host-side, control-plane; numpy).

Bit-identical to ``webradio_tpu.ops.firdesign``: coefficients are
parameters of the serving step, designed on the host and handed to the
device with the next block's parameters.
"""

from __future__ import annotations

import functools

import numpy as np

from .window import hamming

FIR_LENGTH = 64  # reference fixed tap count, src/dsp/lowpass.cxx:39


def design_lowpass_fir(
    passband_hz: int,
    input_rate_hz: int,
    fir_length: int = FIR_LENGTH,
) -> np.ndarray:
    """Design a lowpass FIR the way the reference does (lowpass.cxx:164-197).

    Brick-wall magnitude spectrum up to ``maxbin = fir_length * passband /
    fs / 2`` in C++ unsigned integer division (lowpass.cxx:167), mirrored
    negative frequencies, unnormalized inverse DFT, fftshift reorder and a
    Hamming window carrying the 1/N scale.

    Below ``2 * fs / fir_length`` (7.5 kHz at the 240 kHz channel rate)
    ``maxbin`` truncates to zero and every tap is zero: the reference goes
    silent at narrow passbands, and so does this design.

    Returns float32 ``[fir_length]`` coefficients in time order.
    """
    n = int(fir_length)
    if n & (n - 1):
        raise ValueError("fir_length must be a power of 2")
    maxbin = (n * int(passband_hz)) // int(input_rate_hz) // 2
    spec = np.zeros(n, dtype=np.complex64)
    k = np.arange(n // 2 + 1)
    passed = (k < maxbin).astype(np.float32)
    spec[k] = passed
    spec[(n - k) & (n - 1)] = passed
    impulse = (np.fft.ifft(spec) * n).astype(np.complex64)
    shift = np.arange(n)
    reordered = impulse[(shift + n // 2) & (n - 1)].real.astype(np.float32)
    return reordered * (hamming(n) / np.float32(n))


def design_lowpass_fir_sinc(
    passband_hz: int,
    input_rate_hz: int,
    fir_length: int = FIR_LENGTH,
) -> np.ndarray:
    """Hamming-windowed-sinc lowpass with cutoff ``passband / 2`` Hz and
    unity DC gain: the quirk-free design that keeps narrow passbands
    audible (``fir_design="sinc"``)."""
    n = int(fir_length)
    fc = float(passband_hz) / 2.0 / float(input_rate_hz)  # cycles/sample
    if fc <= 0 or fc > 0.5:
        raise ValueError("passband out of range for this input rate")
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    h = 2.0 * fc * np.sinc(2.0 * fc * t)
    h *= hamming(n).astype(np.float64)
    h /= h.sum()
    return h.astype(np.float32)


DESIGNS = {
    "reference": design_lowpass_fir,
    "sinc": design_lowpass_fir_sinc,
}


@functools.lru_cache(maxsize=512)
def _design_cached(passband_hz: int, input_rate_hz: int, fir_length: int,
                   design: str):
    out = DESIGNS[design](passband_hz, input_rate_hz, fir_length)
    out.setflags(write=False)
    return out


def design_lowpass_fir_cached(
    passband_hz: int, input_rate_hz: int, fir_length: int = FIR_LENGTH,
    design: str = "reference",
) -> np.ndarray:
    """Memoized FIR design (read-only array); ``design`` picks the law
    (:data:`DESIGNS`). Thousands of slots share a handful of bandwidths,
    so a parameter rebuild designs O(distinct bandwidths) filters."""
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {sorted(DESIGNS)}")
    return _design_cached(int(passband_hz), int(input_rate_hz),
                          int(fir_length), design)
