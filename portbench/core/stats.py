"""Statistics over all samples of a window (never over chunks or medians)."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float | None:
    """The q-th percentile of every value (numpy's linear interpolation);
    None without values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
