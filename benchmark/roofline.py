"""The least time one H100 could take for a block's serving step, counted
from the shapes alone (a frozen copy of ``bench_torch.roofline_ms``,
``tail_flops`` and ``tail_bytes``, kept here so that a change to the
program cannot move the yardstick).

The step is two stages that serialize (kernel #1 reads the product that
the filterbank GEMM wrote), each bound by the larger of its operations
over the peak rate and its bytes over the memory bandwidth. A byte is
counted once where it is read and once where it is written.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores,
#: bfloat16 on them, device memory bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

#: each filterbank tier's contraction depth as a multiple of 2 K_p, and
#: whether its GEMM runs on bfloat16 operands (u8exact doubles K, "high"
#: triples it)
PFB_K = {"highest": (1, False), "u8exact": (2, True), "default": (1, True),
         "high": (3, True), "bf16": (1, True)}


def _bound(fp32_flops: float, bf16_flops: float, nbytes: float):
    """``(ops ms, bytes ms)`` at the card's peaks."""
    ops = 1e3 * (fp32_flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS)
    return ops, 1e3 * nbytes / PEAK_BYTES_PER_S


def tail_flops(nd: int, c: int, k: int = 64, d: int = 5) -> float:
    """Kernel #1's float32 operations a block: per row and channel the
    shaping FIR on both planes (4K), the mix (6), the power (4) and the
    decimating audio FIR (2K/D); transcendentals and the demod law left
    out."""
    return nd * c * (4 * k + 10 + 2 * k / d)


def tail_bytes(nd: int, c: int, product_bytes: int = 4, k: int = 64,
               d: int = 5) -> float:
    """Kernel #1's bytes a block: the packed product, the audio, the
    carries read and written, the power, and the per-channel phase, step
    and law."""
    carries = (2 * (k - 1) + 2 + (k - 1)) * c * 4
    return (nd * 2 * c * product_bytes + (nd // d) * c * 4 + 2 * carries
            + c * 4 + c * (8 + 8 + 4))


def roofline_ms(c: int, pfb: str, nd: int = 10_240, kp2: int = 320) -> dict:
    """The two stages of one block at ``c`` channels and filterbank tier
    ``pfb``: the GEMM ``[nd, K] x [K, 2C]`` (float32 outside the tensor
    cores at "highest", bfloat16 on them otherwise) with its frames and
    weights read and the packed product written, then kernel #1.
    ``ideal_ms`` is their sum."""
    mult, bf16 = PFB_K[pfb]
    k = kp2 * mult
    gemm = 2.0 * nd * k * 2 * c
    operand = 2 if bf16 else 4
    product = 2 if pfb == "bf16" else 4
    front_ops, front_bytes = _bound(0.0 if bf16 else gemm,
                                    gemm if bf16 else 0.0,
                                    nd * k * operand + k * 2 * c * operand
                                    + nd * 2 * c * product)
    tail_ops, tail_b = _bound(tail_flops(nd, c), 0.0,
                              tail_bytes(nd, c, product))
    front, tail = max(front_ops, front_bytes), max(tail_ops, tail_b)
    return {"front_ops_ms": front_ops, "front_bytes_ms": front_bytes,
            "tail_ops_ms": tail_ops, "tail_bytes_ms": tail_b,
            "front_ms": front, "tail_ms": tail, "ideal_ms": front + tail}
