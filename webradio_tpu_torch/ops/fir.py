"""Decimating FIR filtering — port of the time-major Toeplitz form of
``webradio_tpu.ops.fir``.

The reference evaluates a 64-tap direct-form FIR at every retained
(decimated) output, carrying ``K - 1`` frames of history between blocks
(src/dsp/lowpass.cxx:131-162). :func:`fir_decimate_toeplitz_tm` computes
the same correlation as float32 matmuls against a banded (Toeplitz) weight
matrix built on the host (:func:`toeplitz_weights`); the weight builders
are numpy and bit-identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .precision import full_fp32


def toeplitz_tile(nd_out: int, decimation: int, fir_length: int) -> int:
    """Output-tile size for :func:`toeplitz_weights`, or 0 when no tile is
    eligible: the tile must divide ``nd_out`` and satisfy
    ``tile * decimation >= fir_length - 1`` (the halo fits in one
    neighbouring tile). Candidate order is the JAX package's."""
    order = (128, 256, 64, 32, 16, 8) if decimation == 1 else (
        32, 64, 128, 16, 8, 256)
    for t in order:
        if nd_out % t == 0 and t * decimation >= fir_length - 1:
            return t
    return 0


def toeplitz_weights(
    coeff: np.ndarray, decimation: int, tile: int
) -> np.ndarray:
    """Banded weight matrix ``W [span, T]`` for one shared FIR kernel.

    ``span = (T - 1) * D + K``; column ``m`` holds the reversed kernel at
    row offset ``m * D``, so a ``[span]`` input window times ``W`` gives
    ``T`` consecutive decimated outputs (lowpass.cxx:151-159).
    """
    c = np.asarray(coeff, np.float32)
    if c.ndim != 1:
        raise ValueError("toeplitz_weights needs one shared [K] kernel")
    k = c.shape[-1]
    d, t = int(decimation), int(tile)
    w = np.zeros(((t - 1) * d + k, t), np.float32)
    rev = c[::-1]
    for m in range(t):
        w[m * d : m * d + k, m] = rev
    return w


def maybe_toeplitz_weights(
    coeff_rows: np.ndarray, decimation: int, nd_out: int
) -> np.ndarray | None:
    """The ``[span, T]`` banded weights when every channel row of
    ``coeff_rows [C, K]`` is identical and an eligible tile exists; None
    otherwise (the step then needs the per-channel FIR form)."""
    rows = np.asarray(coeff_rows)
    if rows.ndim != 2 or not (rows == rows[0]).all():
        return None
    tile = toeplitz_tile(int(nd_out), int(decimation), rows.shape[-1])
    if tile == 0:
        return None
    return toeplitz_weights(rows[0], decimation, tile)


def taps_of(w: torch.Tensor, decimation: int) -> int:
    """Kernel length ``K`` of a ``[span, T]`` banded weight matrix."""
    span, t = w.shape
    return span - (t - 1) * int(decimation)


def fir_decimate_toeplitz_tm(
    x: torch.Tensor,
    w: torch.Tensor,
    decimation: int,
    history: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Time-major Toeplitz FIR: ``x [N, C] -> y [N // D, C]``.

    ``history [K-1, C]`` is the previous block's input tail;
    ``new_history = x[-(K-1):]``. The banded product runs as ``nb``
    batched ``[T, stride] x [stride, C]`` matmuls plus a second small one
    over the next tile's leading halo rows, in true float32.
    """
    d = int(decimation)
    span, t = w.shape
    k = taps_of(w, d)
    if history.shape[0] != k - 1:
        raise ValueError("history length does not match the kernel length")
    n = x.shape[0]
    if n % d:
        raise ValueError(
            "block length must be a multiple of the decimation factor so the "
            "decimation grid stays aligned across blocks"
        )
    nd = n // d
    if nd % t:
        raise ValueError(f"output length {nd} not a multiple of tile {t}")
    if k - 1 > t * d:
        raise ValueError(
            "tile too short: the overlap halo must fit in one neighbor "
            f"tile (fir_length-1={k-1} > tile*decimation={t * d})"
        )
    nb = nd // t
    stride = t * d
    c = x.shape[1]

    xext = torch.cat([history, x], dim=0)  # [N + K - 1, C]
    pad = stride + nb * stride - xext.shape[0]
    xp = F.pad(xext, (0, 0, 0, pad))
    a = xp[: nb * stride].reshape(nb, stride, c)
    halo = span - stride
    wt = w.T  # [T, span]
    with full_fp32():
        if halo > 0:
            b = xp[stride : stride + nb * stride].reshape(nb, stride, c)
            y = wt[:, :stride] @ a + wt[:, stride:] @ b[:, :halo]
        else:
            y = wt @ a[:, :span]
    return y.reshape(nd, c), x[n - (k - 1):]
