"""Four-quadrant arctangent from elementwise primitives.

The same degree-19 odd polynomial as ``webradio_tpu.ops.trig`` (and as the
CUDA tail kernel, ``csrc/tail_tm.cu``), so the FM discriminator gives the
same float32 answer on every path:

* reduce to ``z = min(|y|,|x|) / max(|y|,|x|)`` in [0, 1];
* Horner on ``z^2`` for ``atan(z)`` (max abs error ~1e-9);
* undo the reduction with quadrant selects.

Edge cases follow ``np.arctan2``: ``atan2(0, 0) = 0``, ``atan2(0, -x) = pi``.
"""

from __future__ import annotations

import numpy as np
import torch

# odd-power coefficients for atan(z), z in [0, 1]: z, z^3, ..., z^19
ATAN_COEFFS = np.array(
    [
        0.9999999840770922,
        -0.3333319455350784,
        0.1999662370609189,
        -0.14248404064492634,
        0.10882186235872297,
        -0.08222618452601467,
        0.05514329326685075,
        -0.02858074294703217,
        0.009606052476262018,
        -0.0015163530595570735,
    ],
    dtype=np.float32,
)

_HALF_PI = float(np.float32(np.pi / 2))
_PI = float(np.float32(np.pi))


def _atan_unit(z: torch.Tensor) -> torch.Tensor:
    """atan(z) for z in [0, 1] (Horner on z^2, float32)."""
    z2 = z * z
    acc = torch.full_like(z, float(ATAN_COEFFS[-1]))
    for c in ATAN_COEFFS[-2::-1]:
        acc = acc * z2 + float(c)
    return acc * z


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Four-quadrant arctangent of float32 tensors."""
    ax = x.abs()
    ay = y.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    z = lo / torch.where(hi == 0, torch.ones_like(hi), hi)  # 0 at x = y = 0
    a = _atan_unit(z)
    a = torch.where(ay > ax, _HALF_PI - a, a)
    a = torch.where(x < 0, _PI - a, a)
    return torch.where(y < 0, -a, a)
