"""Polyphase DFT-filterbank channelizer — port of the direct time-major
path of ``webradio_tpu.ops.channelizer``.

For bin ``c`` of a ``D``-band filterbank with prototype ``h``,

    y_c[m] = sum_k (h[k] e^{+j 2 pi c k / D}) * x[m*D - k]

so every receiver's downconverted, prototype-filtered, decimated stream is
one column pair of a single matmul ``[nd, 2 K_p] x [2 K_p, 2 C]`` over the
im2col frames of the wideband block. The filterbank carries only the
``K_p - 1`` input-sample history. The weight builders are numpy and
bit-identical to the JAX package's; the matmul is true float32 (the
"highest" tier).
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import full_fp32


def design_prototype(
    fs_hz: int, num_bins: int, taps_per_phase: int = 16
) -> np.ndarray:
    """Windowed-sinc prototype lowpass for a ``num_bins``-band filterbank:
    cutoff at the bin edge ``fs / (2 * num_bins)``, length
    ``num_bins * taps_per_phase``, Hamming window, unit DC gain."""
    kp = int(num_bins) * int(taps_per_phase)
    n = np.arange(kp, dtype=np.float64) - (kp - 1) / 2.0
    fc = 0.5 / num_bins  # normalized single-sided cutoff
    h = 2 * fc * np.sinc(2 * fc * n)
    w = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(kp) / (kp - 1))
    h = h * w
    return (h / h.sum()).astype(np.float32)


def bin_weights(proto: np.ndarray, num_bins: int) -> np.ndarray:
    """Combined prototype-times-DFT weight matrix ``B [K_p, 2 D]``:
    columns ``0..D-1`` hold ``h[k] cos(2 pi c k / D)``, columns
    ``D..2D-1`` hold ``h[k] sin(2 pi c k / D)``."""
    kp = proto.shape[0]
    d = int(num_bins)
    k = np.arange(kp)[:, None]
    c = np.arange(d)[None, :]
    ang = 2.0 * np.pi * (k * c % d) / d
    b = np.empty((kp, 2 * d), np.float32)
    b[:, :d] = proto[:, None] * np.cos(ang)
    b[:, d:] = proto[:, None] * np.sin(ang)
    return b


def bin_weights_for_channels(
    proto: np.ndarray, num_bins: int, bin_idx: np.ndarray
) -> np.ndarray:
    """Per-channel weight tensor ``Bc [2 K_p, 2, C]`` — bin selection and
    the complex (conjugate-LO) combine folded into the filterbank.

    Rows ``0..K_p-1`` weight the I-plane taps, rows ``K_p..2K_p-1`` the
    Q-plane taps; slot ``[0, c]`` is channel ``c``'s mixed I, ``[1, c]``
    its mixed Q::

        out_i =  sum_k h cos(phi) i_k  -  sum_k h sin(phi) q_k
        out_q =  sum_k h sin(phi) i_k  +  sum_k h cos(phi) q_k
    """
    kp = proto.shape[0]
    d = int(num_bins)
    k = np.arange(kp)[:, None]
    c = np.asarray(bin_idx, np.int64)[None, :]
    ang = 2.0 * np.pi * (k * c % d) / d
    hcos = (proto[:, None] * np.cos(ang)).astype(np.float32)
    hsin = (proto[:, None] * np.sin(ang)).astype(np.float32)
    b = np.empty((2 * kp, 2, c.shape[1]), np.float32)
    b[:kp, 0, :] = hcos
    b[kp:, 0, :] = -hsin
    b[:kp, 1, :] = hsin
    b[kp:, 1, :] = hcos
    return b


def assign_bins(if_hz, fs_hz: int, num_bins: int):
    """Nearest-bin assignment for arbitrary IFs.

    Returns ``(bin_idx [C] int32, residual_hz [C] int64)`` with
    ``if = bin * fs / D + residual`` and ``|residual| <= fs / (2 D)``.
    Negative IFs map to the aliased high bins (bin index mod D).
    """
    ifs = np.atleast_1d(np.asarray(if_hz, dtype=np.int64))
    spacing = fs_hz / num_bins
    nearest = np.round(ifs / spacing).astype(np.int64)
    residual = ifs - (nearest * fs_hz) // num_bins
    return (nearest % num_bins).astype(np.int32), residual


def pfb_frames_tm(
    x: torch.Tensor,
    kp: int,
    decimation: int,
    history: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed im2col frames ``[nd, 2 K_p]`` for the direct filterbank.

    Row ``m`` holds the ``K_p`` delayed I samples then the ``K_p`` delayed
    Q samples feeding output ``m``: ``F[m, k] = xext[(K_p-1-k) + m*D]``
    with ``xext = history ++ x``. Built from one strided window view
    (``unfold``) reversed along the tap axis.

    Returns ``(frames [nd, 2 K_p], new_history [2, K_p - 1])``.
    """
    d = int(decimation)
    n = x.shape[-1]
    if n % d:
        raise ValueError("block length must be a multiple of the decimation")
    xext = torch.cat([history, x], dim=-1)  # [2, N + K_p - 1]
    f = xext.unfold(-1, kp, d).flip(-1)  # [2, nd, K_p]
    f2 = torch.cat([f[0], f[1]], dim=-1)  # [nd, 2 K_p]
    return f2, x[:, n - (kp - 1):].clone()


def pfb_channelize_direct_tm(
    x: torch.Tensor,
    weights: torch.Tensor,
    decimation: int,
    history: torch.Tensor,
    split: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[2, N] -> (i [nd, C], q [nd, C], new_history)`` through the
    filterbank matmul in true float32.

    ``weights`` is :func:`bin_weights_for_channels`' ``[2 K_p, 2, C]``.
    With ``split=False`` the packed ``[nd, 2C]`` product (columns ``[:C]``
    mixed I, ``[C:]`` mixed Q) is returned unsliced as
    ``(y2, y2, new_history)`` for consumers that address it in place.
    """
    kp = weights.shape[0] // 2
    c = weights.shape[-1]
    f2, new_history = pfb_frames_tm(x, kp, decimation, history)
    with full_fp32():
        y = f2 @ weights.reshape(weights.shape[0], 2 * c)
    if not split:
        return y, y, new_history
    return y[:, :c], y[:, c:], new_history
