"""Decimating FIR filtering — port of ``webradio_tpu.ops.fir``.

The reference evaluates a 64-tap direct-form FIR at every retained
(decimated) output, carrying ``K - 1`` frames of history between blocks
(src/dsp/lowpass.cxx:131-162). :func:`fir_decimate` is that loop as ``K``
shifted multiply-adds, with shared or per-channel coefficients.
:func:`fir_decimate_toeplitz_tm` (time-major) and
:func:`fir_decimate_toeplitz` (time-minor) compute the same correlation as
float32 matmuls against a banded (Toeplitz) weight matrix built on the host
(:func:`toeplitz_weights`); the weight functions are numpy and bit-identical
to the JAX package's. :func:`fir_dispatch` routes one call between the two
forms. :func:`overlap_save_decimate` is the frequency-domain form the
direct engine takes under ``ChainConfig.use_overlap_save``.
:func:`fir_decimate_banded_tf32x3_tm` is the plain emulation of the CUDA
tails' tensor-core audio FIR.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .precision import full_fp32, matmul_tf32x3


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


def _check_block(n: int, decimation: int) -> None:
    if n % decimation:
        raise ValueError(
            "block length must be a multiple of the decimation factor so the "
            "decimation grid stays aligned across blocks"
        )


def fir_decimate(
    x: torch.Tensor,
    coeff: torch.Tensor,
    decimation: int,
    history: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decimating FIR with explicit history carry, time-minor.

    ``x [..., N]`` with ``N`` a multiple of ``decimation``; ``coeff [K]``
    shared or ``[C, K]`` per-channel (broadcast against ``x``'s axis -2)
    in design order; ``history [..., K-1]`` the previous block's input
    tail. Returns ``(y [..., N // D], new_history = x[..., -(K-1):])``.

    ``out[n] = sum_k coeff[K-1-k] * block[n*D + k]`` with ``block`` =
    history ++ input (lowpass.cxx:151-159), accumulated tap by tap in the
    JAX package's order; each tap reads one strided view of the extended
    block.
    """
    d = int(decimation)
    k = coeff.shape[-1]
    n = x.shape[-1]
    _check_block(n, d)
    nd = n // d
    xext = torch.cat([history, x], dim=-1)  # [..., N + K - 1]
    kernel = coeff.flip(-1).to(torch.float32)
    acc = torch.zeros(x.shape[:-1] + (nd,), dtype=torch.float32,
                      device=x.device)
    for tap in range(k):
        wk = kernel[tap] if kernel.ndim == 1 else kernel[..., tap:tap + 1]
        acc = acc + wk * xext[..., tap:tap + (nd - 1) * d + 1:d]
    return acc, x[..., n - (k - 1):].contiguous()


def fir_decimate_toeplitz(
    x: torch.Tensor,
    w: torch.Tensor,
    decimation: int,
    history: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Time-minor Toeplitz FIR, the contract of :func:`fir_decimate` for
    one shared kernel: ``x [..., N] -> y [..., N // D]`` as ``nb`` tiles
    ``[..., nb, span] x [span, T]`` in true float32 (the leading ``stride``
    columns of a tile and the ``span - stride`` halo columns from the next
    tile are two matmuls, summed)."""
    d = int(decimation)
    span, t = w.shape
    k = taps_of(w, d)
    if history.shape[-1] != k - 1:
        raise ValueError("history length does not match the kernel length")
    n = x.shape[-1]
    _check_block(n, d)
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
    lead = x.shape[:-1]

    xext = torch.cat([history, x], dim=-1)  # [..., N + K - 1]
    xp = F.pad(xext, (0, stride + nb * stride - xext.shape[-1]))
    a = xp[..., : nb * stride].reshape(lead + (nb, stride))
    halo = span - stride
    with full_fp32():
        if halo > 0:
            b = xp[..., stride : stride + nb * stride].reshape(
                lead + (nb, stride))
            y = a @ w[:stride] + b[..., :halo] @ w[stride:]
        else:
            y = a[..., :span] @ w
    return y.reshape(lead + (nd,)), x[..., n - (k - 1):].contiguous()


def fir_dispatch(x, coeff, toep, decimation, history):
    """Route one time-minor FIR call: the Toeplitz form when the shared
    weights exist and this block's output length is whole tiles, else the
    per-channel multiply-add form."""
    if toep is not None and (x.shape[-1] // decimation) % toep.shape[1] == 0:
        return fir_decimate_toeplitz(x, toep, decimation, history)
    return fir_decimate(x, coeff, decimation, history)


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
    _check_block(n, d)
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


def fir_decimate_banded_tf32x3_tm(
    x: torch.Tensor,
    h_rev: torch.Tensor,
    decimation: int,
    history: torch.Tensor,
    outputs: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain emulation of the CUDA tails' decimating audio FIR on the
    tensor cores (``csrc/tail_tm.cu``, built for decimation 5): the contract
    of :func:`fir_decimate_toeplitz_tm` with the reversed kernel ``h_rev
    [K]`` in place of the banded weights.

    Per group of ``outputs * D`` rows starting at row ``G``, ``outputs``
    consecutive outputs are ``band [outputs, K + outputs * D] . window``,
    where the window is rows ``G - K .. G + outputs * D - 1`` of the stream
    and ``band[o, j] = h_rev[j - D * o - 1]`` (column 0 is padding), as a
    three-term TF32 split with float32 sums
    (:func:`..precision.matmul_tf32x3`). ``N`` must be whole groups.
    """
    d = int(decimation)
    k = h_rev.shape[0]
    n, c = x.shape
    group = outputs * d
    if history.shape[0] != k - 1:
        raise ValueError("history length does not match the kernel length")
    if n % group:
        raise ValueError(f"{n} rows is not a multiple of the group {group}")
    span = k + group
    band = torch.zeros(outputs, span, dtype=torch.float32, device=x.device)
    for o in range(outputs):
        band[o, d * o + 1:d * o + 1 + k] = h_rev
    pad = torch.zeros(1, c, dtype=x.dtype, device=x.device)
    ext = torch.cat([pad, history, x], dim=0)  # row i is stream row i - K
    win = ext.unfold(0, span, group)  # [n / group, C, span]
    y = matmul_tf32x3(band, win.transpose(1, 2).contiguous())
    return y.reshape(n // d, c), x[n - (k - 1):]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def overlap_save_decimate(
    x: torch.Tensor,
    coeff: torch.Tensor,
    decimation: int,
    history: torch.Tensor,
    segment_len: int | None = None,
    fft_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Frequency-domain decimating FIR (overlap-save), the contract of
    :func:`fir_decimate`.

    The input with its history prepended is cut into ``N / S`` segments of
    ``L = fft_len`` samples overlapping by ``L - S >= K - 1``; each is
    convolved circularly through ``torch.fft`` and the first ``K - 1``
    wrapped outputs are discarded. Segment and transform lengths are the
    JAX package's. Differs from the direct form by float32 FFT rounding.
    """
    k = coeff.shape[-1]
    n = x.shape[-1]
    _check_block(n, decimation)
    if segment_len is None:
        segment_len = min(4096, _next_pow2(n) if _next_pow2(n) <= n else n)
        while n % segment_len:
            segment_len //= 2
    s = segment_len
    if n % s:
        raise ValueError(f"segment_len {s} must divide N {n}")
    fft_n = fft_len or _next_pow2(s + k - 1)
    if fft_n < s + k - 1:
        raise ValueError("fft_len too small for segment + filter overlap")
    num_seg = n // s

    xext = torch.cat([history, x], dim=-1)  # [..., N + K - 1]
    xpad = F.pad(xext, (0, (num_seg - 1) * s + fft_n - xext.shape[-1]))
    segs = xpad.unfold(-1, fft_n, s)  # [..., num_seg, L]
    # circular convolution with the design-order coefficients equals the
    # reference's reversed-coefficient correlation at output offset K - 1
    hf = torch.fft.fft(F.pad(coeff.to(torch.float32), (0, fft_n - k)).to(
        torch.complex64))
    if coeff.ndim > 1:
        hf = hf[..., None, :]  # broadcast over segments
    yf = torch.fft.ifft(torch.fft.fft(segs.to(torch.complex64)) * hf)
    valid = yf[..., k - 1:k - 1 + s]  # [..., num_seg, S]
    yfull = valid.reshape(valid.shape[:-2] + (num_seg * s,))
    y = yfull[..., ::decimation].real.to(torch.float32).contiguous()
    return y, x[..., n - (k - 1):].contiguous()
