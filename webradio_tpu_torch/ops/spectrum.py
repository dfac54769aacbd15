"""Spectrum analyzer feeding the waterfall — port of
``webradio_tpu.ops.spectrum``.

Hamming window and a ``fft_size``-point DFT per group of frames, written as
two float32 matmuls against cos/sin DFT matrices (src/io/spectrumsink.cxx:
88-142). ``block_frames % fft_size == 0`` makes the reference's fill offset
zero, so there is no cross-block spectrum state.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .precision import full_fp32
from .window import hamming

DEFAULT_FFT_SIZE = 512  # src/io/spectrumsink.h:34


@functools.lru_cache(maxsize=8)
def dft_matrices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Cos/sin DFT matrices ``C[t, k] = cos(2 pi t k / n)`` etc., built in
    float64 and rounded once to float32 (bit-identical to the JAX
    package's constants)."""
    t = np.arange(n)[:, None].astype(np.float64)
    k = np.arange(n)[None, :].astype(np.float64)
    theta = 2.0 * np.pi * t * k / n
    return (
        np.cos(theta).astype(np.float32),
        np.sin(theta).astype(np.float32),
    )


@functools.lru_cache(maxsize=8)
def _constants(n: int, device: torch.device):
    """Window and DFT matrices on ``device`` (built once per device)."""
    cmat, smat = dft_matrices(n)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (hamming(n), cmat, smat))


def spectrum_accumulate(
    x: torch.Tensor, fft_size: int = DEFAULT_FFT_SIZE
) -> torch.Tensor:
    """Window + DFT every ``fft_size``-frame group of the block.

    ``x [2, N]`` float32 IQ planes, ``N % fft_size == 0``. Returns
    ``[2, N // fft_size, fft_size]`` raw DFT planes (re, im) in stream
    order; row ``[-1]`` is the reference's latest frame.
    """
    n = x.shape[-1]
    if n % fft_size:
        raise ValueError("block length must be a multiple of fft_size")
    g = n // fft_size
    win, cmat, smat = _constants(fft_size, x.device)
    xr = x[0].reshape(g, fft_size) * win
    xi = x[1].reshape(g, fft_size) * win
    with full_fp32():
        re = xr @ cmat + xi @ smat
        im = xi @ cmat - xr @ smat
    return torch.stack([re, im])


def spectrum_db(spec: torch.Tensor) -> torch.Tensor:
    """Raw DFT planes ``[2, ..., F]`` -> dB magnitudes ``[..., F]`` in
    ascending-frequency order: ``10*log10(re^2 + im^2) - 20*log10(F)``
    with fftshift (spectrumsink.cxx:125-142). Zero power maps to -inf."""
    f = spec.shape[-1]
    scaledb = float(np.float32(20.0) * np.log10(np.float32(f)))
    power = spec[0] * spec[0] + spec[1] * spec[1]
    db = 10.0 * torch.log10(power) - scaledb
    return torch.cat([db[..., f // 2:], db[..., : f // 2]], dim=-1)
