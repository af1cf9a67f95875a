"""Worker schedules shared by the engines (the JAX package's
``core/sync.py``, the part the BSP device step uses).

``default_periods`` is the deterministic heterogeneous worker-speed
schedule, and ``ElasticWorkerSet`` the straggler surface every engine
inherits; the port keeps its backup drop set.  The simulator
(``SimSyncEngine``), the SSP/ASP firing schedule, straggler slowdowns and
measured straggler detection are ROADMAP queue A items 6 and 7.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.elastic.backup import drop_set


def default_periods(num_workers: int) -> Tuple[int, ...]:
    """Heterogeneous-by-default deterministic worker speeds (worker i
    finishes every i+1 ticks)."""
    return tuple(1 + i for i in range(num_workers))


class ElasticWorkerSet:
    """The backup-drop accounting over the workers' speed schedule.
    Subclass ``__init__`` sets ``self.periods``, ``self.slowdowns`` (per
    worker period factors, 1.0 = none) and ``self._dropped``."""

    periods: Tuple[int, ...]
    slowdowns: List[float]
    _dropped: int

    def backup_drop(self, k: int):
        """The round's backup drop set: the scheduled ranking of
        ``elastic.backup.drop_set``."""
        return drop_set(self.periods, k, self.slowdowns)

    def dropped_updates(self) -> int:
        """Gradient pushes discarded by the backup-worker policy."""
        return self._dropped
