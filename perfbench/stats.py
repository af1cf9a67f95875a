"""Order statistics of the harness's own records."""
from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile by linear interpolation between the closest
    ranks (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    k = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def median(values: Sequence[float]) -> Optional[float]:
    return percentile(values, 50.0)
