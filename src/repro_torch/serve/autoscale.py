"""Open-loop arrival traces for the serving plane (the JAX package's
``serve/autoscale.py::poisson_trace``; the autoscaler itself comes with a
later slice)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def poisson_trace(rate: float, horizon: float, seed: int = 0,
                  max_requests: Optional[int] = None) -> List[float]:
    """Open-loop Poisson arrivals: exponential inter-arrival times at
    ``rate`` req/s over ``horizon`` seconds (arrivals do NOT wait for
    completions)."""
    rng = np.random.RandomState(seed)
    out: List[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= horizon or (max_requests and len(out) >= max_requests):
            return out
        out.append(t)
