"""Polyphase DFT-filterbank channelizer — port of the direct paths of
``webradio_tpu.ops.channelizer`` (time-major, and the time-minor
``[2, C, nd]`` form of the per-channel fallback).

For bin ``c`` of a ``D``-band filterbank with prototype ``h``,

    y_c[m] = sum_k (h[k] e^{+j 2 pi c k / D}) * x[m*D - k]

so every receiver's downconverted, prototype-filtered, decimated stream is
one column pair of a single matmul ``[nd, 2 K_p] x [2 K_p, 2 C]`` over the
im2col frames of the wideband block. The filterbank carries only the
``K_p - 1`` input-sample history. The weight builders are numpy and
bit-identical to the JAX package's.

The product has five tiers (``ChannelizedConfig.pfb_precision``), one law
each, on every device (the JAX package computes "u8exact" at HIGHEST off
the TPU; the port computes the tier's own law everywhere):

- "highest": true float32 (:func:`pfb_product_highest`);
- "u8exact": the frames rounded to bfloat16, exact for 8-bit-sourced input
  (``(u8 - 128) / 128`` spans 256 values, each a bfloat16), times the
  host-split weight pair ``hi + lo`` in one doubled contraction with
  float32 sums (:func:`pfb_product_u8exact`);
- "default": one bfloat16 pass (:func:`pfb_product_default`);
- "high": bfloat16x3, ``ah bh + ah bl + al bh`` (:func:`pfb_product_high`,
  the law of the JAX kernels' ``_band_dot``);
- "bf16": default's arithmetic with the product stored as bfloat16
  (:func:`pfb_product_bf16`).

Every lossy law multiplies bfloat16 values, whose products are exact in
float32, and sums in float32. On the card each is a cuBLAS GEMM on bfloat16
operands (float32 output, or bfloat16 for "bf16") inside
:func:`.precision.full_fp32`, which pins cuBLAS's reduced-precision
bfloat16 reduction off; on the CPU it is a float32 matmul of the same
bfloat16 values, the same law. As in the JAX package, this GEMM is a
library call, not a kernel.
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


#: the filterbank tiers, ``ChannelizedConfig.pfb_precision``
PFB_PRECISIONS = ("default", "high", "highest", "u8exact", "bf16")


def split_weights_u8(weights) -> torch.Tensor:
    """Host-side bfloat16 hi/lo split of the filterbank weights: ``[2,
    2 K_p, 2, C]`` bfloat16 with ``w ~= hi + lo``, ``hi = bf16(w)`` and
    ``lo = bf16(w - hi)`` (round to nearest even, as the JAX package's
    ``astype``). The channel axis stays last, as in the weights. The
    operand of every lossy tier: "u8exact" and "high" read both halves,
    "default" and "bf16" the ``hi`` half. Made once per parameter set, on
    the CPU."""
    w = torch.from_numpy(np.asarray(weights, np.float32))
    hi = w.to(torch.bfloat16)
    lo = (w - hi.float()).to(torch.bfloat16)
    return torch.stack([hi, lo])


def _packed_split(weights_split: torch.Tensor):
    """``(hi, lo)`` as ``[2 K_p, 2 C]`` views of ``[2, 2 K_p, 2, C]``."""
    kp2 = weights_split.shape[1]
    ws = weights_split.reshape(2, kp2, -1)
    return ws[0], ws[1]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bfloat16 matrices with float32 output: the products
    are exact, the sums float32. cuBLAS on the card, a float32 matmul of
    the same values on the CPU. Call inside :func:`.precision.full_fp32`."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def pfb_product_highest(f2: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The "highest" law: ``f2 [nd, 2K_p] @ w2 [2K_p, 2C]`` in true
    float32."""
    with full_fp32():
        return f2 @ w2


def pfb_product_u8exact(f2: torch.Tensor,
                        weights_split: torch.Tensor) -> torch.Tensor:
    """The "u8exact" law: ``[fb | fb] @ [hi ; lo]`` with ``fb`` the frames
    rounded to bfloat16, one contraction over ``4 K_p`` with float32 sums
    (the JAX package's ``pfb_channelize_direct_tm_u8``). Float32-accurate,
    ~2e-6 of the "highest" product, where the frames are 8-bit-sourced."""
    kp2 = weights_split.shape[1]
    fb = f2.to(torch.bfloat16)
    with full_fp32():
        return _mm_f32(torch.cat([fb, fb], dim=1),
                       weights_split.reshape(2 * kp2, -1))


def pfb_product_default(f2: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The "default" law: one bfloat16 pass, ``bf16(f2) @ hi`` with float32
    sums (``hi = bf16(w)``, ``[2K_p, 2C]``)."""
    with full_fp32():
        return _mm_f32(f2.to(torch.bfloat16), hi)


def pfb_product_high(f2: torch.Tensor, hi: torch.Tensor,
                     lo: torch.Tensor) -> torch.Tensor:
    """The "high" law, bfloat16x3: ``ah hi + ah lo + al hi`` with ``ah =
    bf16(f2)``, ``al = bf16(f2 - ah)``; the dropped ``al lo`` term is
    ~2^-16 of the product. One contraction ``[ah | ah | al] @ [hi ; lo ;
    hi]`` with float32 sums (the JAX kernels' ``_band_dot`` sums the three
    products apart and adds them: the same exact products, another order of
    float32 sums; three separate products and two adds of the float32
    ``[nd, 2C]`` output would move four times its bytes)."""
    ah = f2.to(torch.bfloat16)
    al = (f2 - ah.float()).to(torch.bfloat16)
    with full_fp32():
        return _mm_f32(torch.cat([ah, ah, al], dim=1),
                       torch.cat([hi, lo, hi], dim=0))


def pfb_product_bf16(f2: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The "bf16" law: the "default" product (float32 sums) stored as
    bfloat16, one rounding of the float32 sum. On the card cuBLAS's
    bfloat16 GEMM rounds its float32 accumulator once on output."""
    fb = f2.to(torch.bfloat16)
    with full_fp32():
        if fb.device.type == "cuda":
            return torch.mm(fb, hi)
        return (fb.float() @ hi.float()).to(torch.bfloat16)


def pfb_product(f2: torch.Tensor, weights: torch.Tensor,
                weights_split: torch.Tensor | None,
                precision: str = "highest") -> torch.Tensor:
    """The filterbank product ``[nd, 2C]`` of frames ``f2 [nd, 2K_p]`` at
    a tier: ``weights`` is the float32 ``[2K_p, 2, C]`` (read by
    "highest"), ``weights_split`` :func:`split_weights_u8`'s pair (read by
    the others). Float32, or bfloat16 for "bf16"."""
    if precision == "highest":
        return pfb_product_highest(f2, weights.reshape(weights.shape[0], -1))
    if precision not in PFB_PRECISIONS:
        raise ValueError(f"pfb_precision must be one of {PFB_PRECISIONS}")
    if weights_split is None:
        raise ValueError(f"the {precision!r} tier reads the split weights "
                         "(pfb_weights_split), which are absent")
    if precision == "u8exact":
        return pfb_product_u8exact(f2, weights_split)
    hi, lo = _packed_split(weights_split)
    if precision == "high":
        return pfb_product_high(f2, hi, lo)
    if precision == "bf16":
        return pfb_product_bf16(f2, hi)
    return pfb_product_default(f2, hi)


def pfb_channelize_direct_tm(
    x: torch.Tensor,
    weights: torch.Tensor,
    decimation: int,
    history: torch.Tensor,
    split: bool = True,
    precision: str = "highest",
    weights_split: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[2, N] -> (i [nd, C], q [nd, C], new_history)`` through the
    filterbank product at the tier ``precision`` (:func:`pfb_product`;
    bfloat16 planes under "bf16", float32 otherwise).

    ``weights`` is :func:`bin_weights_for_channels`' ``[2 K_p, 2, C]``.
    With ``split=False`` the packed ``[nd, 2C]`` product (columns ``[:C]``
    mixed I, ``[C:]`` mixed Q) is returned unsliced as
    ``(y2, y2, new_history)`` for consumers that address it in place.
    """
    kp = weights.shape[0] // 2
    c = weights.shape[-1]
    f2, new_history = pfb_frames_tm(x, kp, decimation, history)
    y = pfb_product(f2, weights, weights_split, precision)
    if not split:
        return y, y, new_history
    return y[:, :c], y[:, c:], new_history


def pfb_channelize_direct(
    x: torch.Tensor,
    weights: torch.Tensor,
    decimation: int,
    history: torch.Tensor,
    precision: str = "highest",
    weights_split: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``[2, N] -> (chan [2, C, nd], new_history)``: the same product as
    :func:`pfb_channelize_direct_tm`, in float32 at every tier, transposed
    to the time-minor layout (one contiguous copy) for the per-channel
    tail."""
    y, _, new_history = pfb_channelize_direct_tm(
        x, weights, decimation, history, split=False, precision=precision,
        weights_split=weights_split)
    c = weights.shape[-1]
    return y.float().reshape(y.shape[0], 2, c).permute(1, 2, 0).contiguous(), \
        new_history
