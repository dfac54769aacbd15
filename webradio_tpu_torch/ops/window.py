"""Window functions (float32, matching the reference's formulas)."""

from __future__ import annotations

import numpy as np


def hamming(n: int) -> np.ndarray:
    """Hamming window, ``0.54 - 0.46*cos(2*pi*k/(n-1))``.

    Matches src/dsp/lowpass.cxx:108 and src/io/spectrumsink.cxx:73 (float32),
    bit-identical to ``webradio_tpu.ops.window.hamming``.
    """
    k = np.arange(n, dtype=np.float32)
    return (0.54 - 0.46 * np.cos(2 * np.pi * k / np.float32(n - 1))).astype(
        np.float32
    )
