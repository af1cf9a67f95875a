"""Straggler mitigation via backup workers (survey §3.2.3 / §3.3.2): the
JAX package's ``elastic/backup.py``.

``bsp+backup:k`` runs synchronous data parallelism but aggregates only the
fastest N-k workers each step.  Which workers are slowest is
deterministic: the k with the largest effective period (base period times
an active slowdown), ties broken toward the higher worker id.
"""
from __future__ import annotations

from typing import FrozenSet, Optional, Sequence

import numpy as np


def drop_set(periods: Sequence[float], k: int,
             slowdowns: Optional[Sequence[float]] = None) -> FrozenSet[int]:
    """The k slowest workers under the effective speed schedule."""
    n = len(periods)
    if k <= 0:
        return frozenset()
    if k >= n:
        raise ValueError(f"backup k={k} must leave at least one of "
                         f"{n} workers")
    eff = [p * (slowdowns[w] if slowdowns is not None else 1.0)
           for w, p in enumerate(periods)]
    order = sorted(range(n), key=lambda w: (eff[w], w))
    return frozenset(order[n - k:])


def participation_weights(num_workers: int, drop: FrozenSet[int]
                          ) -> np.ndarray:
    """Per-worker aggregation weights for a drop-slowest-k step: a mean
    over ``num_workers`` of the weighted gradients equals the plain mean
    over the participants (dropped workers contribute exact zeros)."""
    n_part = num_workers - len(drop)
    w = np.full((num_workers,), num_workers / max(1, n_part), np.float32)
    if drop:
        w[sorted(drop)] = 0.0
    return w
