"""Control-plane helpers (subset of ``webradio_tpu.pipeline.state``)."""

from __future__ import annotations

import numpy as np


def _squelch_array(values) -> np.ndarray:
    """Squelch thresholds -> float32, with None (gate disabled) as NaN —
    the in-device "no squelch" sentinel of
    :func:`webradio_tpu_torch.pipeline.frontend.squelch_scale`."""
    return np.array(
        [np.nan if v is None else float(v) for v in values], np.float32
    )
