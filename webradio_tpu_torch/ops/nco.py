"""Numerically-controlled oscillator (complex mixer), time-major and
time-minor.

Port of ``webradio_tpu.ops.nco``. The reference NCO is a 31-bit integer
phase accumulator whose top 16 bits index a 2^16-entry sine table
(src/dsp/downconverter.cxx:35-52,91-114); the phase of sample ``n`` has the
closed form ``(phase0 + n * step) mod 2^31``.

Torch's uint32 support is partial, so phases and steps are int64 tensors
holding the uint32 value (a negative step is its uint32 bit pattern). Every
product ``n * step`` stays below 2^63 for any block length this system
runs, and ``& PHASE_MASK`` then gives exactly the uint32 result mod 2^31.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PHASE_BITS = 31  # src/dsp/downconverter.cxx:35
LOOKUP_BITS = 16  # src/dsp/downconverter.cxx:36
PHASE_MASK = (1 << PHASE_BITS) - 1
LOOKUP_MASK = (1 << LOOKUP_BITS) - 1
LOOKUP_SHIFT = PHASE_BITS - LOOKUP_BITS
ANGLE_SCALE = float(np.float32(2.0 * np.pi / (1 << LOOKUP_BITS)))
FULL_ANGLE_SCALE = float(np.float32(2.0 * np.pi / (1 << PHASE_BITS)))


def nco_phase_step(if_hz: int, fs_hz: int) -> int:
    """Phase-accumulator step for a given IF, per downconverter.cxx:80.

    ``int64`` division truncating toward zero, returned as the uint32 bit
    pattern of the (possibly negative) step.
    """
    if if_hz >= 0:
        step = (int(if_hz) * (1 << PHASE_BITS)) // int(fs_hz)
    else:
        step = -((-int(if_hz) * (1 << PHASE_BITS)) // int(fs_hz))
    return step & 0xFFFFFFFF


def nco_advance(phase0: torch.Tensor, phase_step: torch.Tensor,
                n: int) -> torch.Tensor:
    """Closed-form phase after ``n`` samples: ``(phase0 + n*step) mod 2^31``
    — the whole NCO carry between blocks (int64 in, int64 out)."""
    return (phase0 + (n & 0xFFFFFFFF) * phase_step) & PHASE_MASK


def nco_phases_tm(n: int, phase0: torch.Tensor,
                  phase_step: torch.Tensor) -> torch.Tensor:
    """Integer phases ``[n, C]`` of samples ``0..n-1`` (int64, < 2^31)."""
    idx = torch.arange(n, dtype=torch.int64, device=phase0.device)
    return (phase0[None, :] + idx[:, None] * phase_step[None, :]) & PHASE_MASK


def _mix(i, q, s, c):
    return i * c + q * s, q * c - i * s


def _table_sincos(phases: torch.Tensor):
    """``sin``/``cos`` of integer phases at the reference's 16-bit table
    law: ``sin`` evaluated at the quantized angle
    (downconverter.cxx:99-110)."""
    sinidx = phases >> LOOKUP_SHIFT
    cosidx = (sinidx + (1 << LOOKUP_BITS) // 4) & LOOKUP_MASK
    s = torch.sin(sinidx.to(torch.float32) * ANGLE_SCALE)
    c = torch.sin(cosidx.to(torch.float32) * ANGLE_SCALE)
    return s, c


def nco_mix_tm(
    i: torch.Tensor, q: torch.Tensor, phase0: torch.Tensor,
    phase_step: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mix planes ``[N, C]`` with the conjugate LO at the table law."""
    s, c = _table_sincos(nco_phases_tm(i.shape[0], phase0, phase_step))
    return _mix(i, q, s, c)


def nco_mix(x: torch.Tensor, phase0: torch.Tensor,
            phase_step: torch.Tensor) -> torch.Tensor:
    """Time-minor twin of :func:`nco_mix_tm`: ``x [2, C, N]`` (or
    ``[2, 1, N]``, broadcast over channels) mixed with the conjugate LO at
    the table law, ``[2, C, N]`` out. ``phase0 [C]`` is the phase of the
    first sample."""
    idx = torch.arange(x.shape[-1], dtype=torch.int64, device=phase0.device)
    phases = (phase0[:, None] + idx[None, :] * phase_step[:, None]) & PHASE_MASK
    s, c = _table_sincos(phases)
    return torch.stack(_mix(x[0], x[1], s, c))


def _factored_sincos(n: int, phase0: torch.Tensor, phase_step: torch.Tensor):
    """``sin``/``cos`` of the LO phase for samples ``0..n-1``, ``[n, C]``,
    by the coarse/fine factorization of ``webradio_tpu.ops.nco``: with
    ``m = a*B + b`` the integer phase is ``phase0 + a*(B*step) + b*step``,
    so ``e^{j theta_m} = e^{j theta_coarse(a)} * e^{j theta_fine(b)}`` needs
    ~``2*sqrt(n)`` transcendentals per channel. The angle is the full 31-bit
    phase (no 16-bit quantization)."""
    b = 1 << max(1, (max(n - 1, 1).bit_length() + 1) // 2)
    b = min(b, n)
    a = -(-n // b)  # ceil
    dev = phase0.device
    bidx = torch.arange(b, dtype=torch.int64, device=dev)
    aidx = torch.arange(a, dtype=torch.int64, device=dev)
    coarse_step = (phase_step * b) & 0xFFFFFFFF
    coarse = (phase0[None, :] + aidx[:, None] * coarse_step[None, :]) & PHASE_MASK
    fine = (bidx[:, None] * phase_step[None, :]) & PHASE_MASK
    tc = coarse.to(torch.float32) * FULL_ANGLE_SCALE  # [A, C]
    tf = fine.to(torch.float32) * FULL_ANGLE_SCALE  # [B, C]
    sc, cc = torch.sin(tc), torch.cos(tc)
    sf, cf = torch.sin(tf), torch.cos(tf)
    c = cc[:, None, :] * cf[None, :, :] - sc[:, None, :] * sf[None, :, :]
    s = sc[:, None, :] * cf[None, :, :] + cc[:, None, :] * sf[None, :, :]
    return s.reshape(a * b, -1)[:n], c.reshape(a * b, -1)[:n]


def nco_mix_tm_fast(
    i: torch.Tensor, q: torch.Tensor, phase0: torch.Tensor,
    phase_step: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`nco_mix_tm` with the factored-phasor LO
    (:func:`_factored_sincos`): the full 31-bit angle, the JAX package's
    ``fast_nco`` law for the plain (non-kernel) tail."""
    s, c = _factored_sincos(i.shape[0], phase0, phase_step)
    return _mix(i, q, s, c)


def nco_mix_tm_exact(
    i: torch.Tensor, q: torch.Tensor, phase0: torch.Tensor,
    phase_step: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`nco_mix_tm` at the exact 31-bit angle ``2pi * phase / 2^31``
    per sample, evaluated in float64 and rounded to float32. This is the
    fused tail kernel's ``fast`` LO law; the factored phasor of
    :func:`nco_mix_tm_fast` approximates the same angle with two float32
    angle roundings."""
    ang = nco_phases_tm(i.shape[0], phase0, phase_step).to(torch.float64)
    ang = ang * (2.0 * math.pi / (1 << PHASE_BITS))
    s = torch.sin(ang).to(torch.float32)
    c = torch.cos(ang).to(torch.float32)
    return _mix(i, q, s, c)


def nco_mix_tm_rotated(
    i: torch.Tensor, q: torch.Tensor, phase0: torch.Tensor,
    phase_step: torch.Tensor, rows: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain emulation of the CUDA tail kernels' ``fast`` LO: the exact
    phasor (:func:`nco_mix_tm_exact`'s) at every ``rows``-th sample, rotated
    in float32 by the exact phasors of ``0..rows-1`` steps for the samples
    between. At most three float32 roundings (~2e-7) from the exact law on
    each of sin and cos. ``N`` must be a multiple of ``rows``."""
    n = i.shape[0]
    if n % rows:
        raise ValueError(f"{n} rows is not a multiple of {rows}")
    scale = 2.0 * math.pi / (1 << PHASE_BITS)

    def phasor(phases):
        ang = phases.to(torch.float64) * scale
        return torch.sin(ang).to(torch.float32), torch.cos(ang).to(
            torch.float32)

    s0, c0 = phasor(nco_phases_tm(n, phase0, phase_step)[::rows])  # [n/r, C]
    rs, rc = phasor(nco_phases_tm(rows, torch.zeros_like(phase0),
                                  phase_step))  # [rows, C]
    s = s0[:, None, :] * rc[None] + c0[:, None, :] * rs[None]
    c = c0[:, None, :] * rc[None] - s0[:, None, :] * rs[None]
    return _mix(i, q, s.reshape(n, -1), c.reshape(n, -1))
