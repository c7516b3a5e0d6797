"""Statistics the readers and the judge share."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float | None:
    """The q-th percentile of every value (numpy's linear
    interpolation), or None for no values."""
    values = np.asarray(values, np.float64)
    if values.size == 0:
        return None
    return float(np.percentile(values, q))
