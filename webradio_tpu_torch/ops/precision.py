"""Matmul precision pinning.

The spectrum matmuls and the "highest" filterbank tier are true float32;
the other filterbank tiers multiply bfloat16 operands with float32 sums
(``ops.channelizer``). On a CUDA device a float32 matmul may silently run
in TF32 when a caller has flipped the global switches, and cuBLAS may sum a
bfloat16 product in reduced precision unless told not to (PyTorch allows
it by default). Every matmul of the serving path runs inside
:func:`full_fp32`, which pins all three switches off for its duration and
restores the caller's settings afterwards.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Pin ``allow_tf32`` off for cuBLAS and cuDNN, and cuBLAS's
    ``allow_bf16_reduced_precision_reduction`` off, inside the block."""
    matmul = torch.backends.cuda.matmul
    old = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties away from
    zero: the 13 low mantissa bits come back clear. The CUDA kernels do the
    same in integer operations."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) with its 13 low mantissa bits cleared: how a TF32
    tensor-core operand reads a float32 register."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = round_tf32(x)`` and ``lo = x - hi``, which
    float32 holds exactly, so ``hi + lo == x`` bit for bit. ``lo`` is at
    most 2^-11 of ``x`` and has at most 12 significant bits; a tensor-core
    product reads 11 of them (:func:`trunc_tf32`), which leaves at most
    2^-23 of ``x`` behind."""
    hi = round_tf32(x)
    return hi, x - hi


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain emulation of the kernels' split-precision tensor-core product:
    ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` with every operand a TF32 value
    (so each elementwise product is exact in float32) and float32 sums.
    The dropped ``a_lo b_lo`` term is at most 2^-22 of ``|a| |b|``."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    a_lo, b_lo = trunc_tf32(a_lo), trunc_tf32(b_lo)
    with full_fp32():
        return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi

