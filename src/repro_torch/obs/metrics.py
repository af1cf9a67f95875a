"""The nearest-rank ``percentile`` every latency aggregation shares (the
JAX package's ``obs/metrics.py::percentile``; the metrics registry and
tracing come with a later slice)."""
from __future__ import annotations

from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over ``values`` (``q`` in [0, 100]).  An
    empty sample returns ``nan``; a singleton returns its one value."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q!r} outside [0, 100]")
    xs = sorted(float(v) for v in values)
    if not xs:
        return float("nan")
    if len(xs) == 1:
        return xs[0]
    k = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[k]
