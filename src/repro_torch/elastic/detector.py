"""Measured straggler *detection* (survey §3.2.3): per-worker step-time
EMAs feeding the ``bsp+backup:k`` drop set (the JAX package's
``elastic/detector.py``).

The backup-worker policy (elastic/backup.py) originally ranked workers by
the *plan-scheduled* speed schedule — ``slow:wIxF@t`` events the run was
told about.  Real stragglers are not announced; this module measures
them.  Each BSP round, both engines time every worker's host-side work
(batch fetch, plus the gradient computation in the simulator, where it is
per-worker) and fold it into an exponential moving average; once every
worker has ``warmup`` observations, the EMA ranking *replaces* the
scheduled ranking in the drop set (``Strategy(detect=True)`` /
``"bsp+backup:1+detect"``).

Determinism note: the drop set becomes a function of wall-clock
measurements, so detect-mode runs are reproducible only insofar as the
straggler is.  The cross-validation tests drive a real (sleeping) data
source and assert the measured drop set converges to the one the
equivalent ``slow:wIxF`` plan schedules.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.elastic.backup import drop_set


class StepTimeEMA:
    """Per-worker step-time EMA with the same drop-ranking rule as the
    scheduled policy (ties toward the higher worker id)."""

    def __init__(self, num_workers: int, alpha: float = 0.5,
                 warmup: int = 2):
        if not 0 < alpha <= 1:
            raise ValueError("alpha must be in (0, 1]")
        if warmup < 1:
            raise ValueError("warmup must be >= 1")
        self.alpha = alpha
        self.warmup = warmup
        self.ema: List[Optional[float]] = [None] * num_workers
        self.count: List[int] = [0] * num_workers

    def observe(self, worker: int, seconds: float) -> None:
        self.count[worker] += 1
        if self.count[worker] == 1:
            # a worker's first measurement absorbs one-time costs (kernel
            # builds, cold caches and allocator growth) and would
            # mis-rank whoever pays them as the straggler — discard it
            return
        prev = self.ema[worker]
        self.ema[worker] = (seconds if prev is None
                            else self.alpha * seconds
                            + (1 - self.alpha) * prev)

    @property
    def ready(self) -> bool:
        """True once every worker has ``warmup`` measurements — before
        that the engines fall back to the scheduled ranking."""
        return all(c >= self.warmup for c in self.count)

    def factors(self) -> List[float]:
        """Measured slowdown estimates, normalized to the fastest worker
        (1.0 = fastest; unmeasured workers report 1.0)."""
        known = [e for e in self.ema if e is not None]
        base = min(known) if known else 1.0
        base = base or 1.0
        return [1.0 if e is None else e / base for e in self.ema]

    def drop_set(self, k: int):
        """The k measured-slowest workers, same tie rule as the scheduled
        policy."""
        return drop_set([1.0 if e is None else e for e in self.ema], k)

    # ------------------------------------------------------ elastic plumbing
    def reshard(self, slots: Sequence[int], new_workers: int) -> None:
        """Survivor slots keep their measurements; grown slots start
        unmeasured (and hold the drop set back until re-warmed)."""
        grown = new_workers - len(slots)
        self.ema = [self.ema[s] for s in slots] + [None] * grown
        self.count = [self.count[s] for s in slots] + [0] * grown

    def state(self) -> Dict:
        return {"ema": list(self.ema), "count": list(self.count)}

    def load_state(self, state: Optional[Dict]) -> None:
        if not state:
            return
        self.ema = [None if e is None else float(e) for e in state["ema"]]
        self.count = [int(c) for c in state["count"]]
