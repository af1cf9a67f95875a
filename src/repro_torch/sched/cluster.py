"""Cluster model: nodes x GPUs with locality (survey §3.4.2, Jeon et al.
[78]: locality + interference are first-order scheduler concerns); the JAX package's ``sched/cluster.py``."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Cluster:
    n_nodes: int = 4
    gpus_per_node: int = 8
    # fragmentation penalty: cross-node jobs run this much slower
    cross_node_penalty: float = 1.15

    def __post_init__(self):
        self.free: List[int] = [self.gpus_per_node] * self.n_nodes
        self.alloc: Dict[int, List[Tuple[int, int]]] = {}

    @property
    def total_gpus(self) -> int:
        return self.n_nodes * self.gpus_per_node

    @property
    def free_gpus(self) -> int:
        return sum(self.free)

    def try_alloc(self, jid: int, n: int) -> Optional[float]:
        """Allocate n GPUs; prefer single-node packing (locality).  Returns
        the slowdown factor (1.0 local, penalty if spread), or None."""
        if n > self.free_gpus:
            return None
        # best-fit single node
        candidates = [i for i in range(self.n_nodes) if self.free[i] >= n]
        if candidates:
            node = min(candidates, key=lambda i: self.free[i])
            self.free[node] -= n
            self.alloc[jid] = [(node, n)]
            return 1.0
        # spread across nodes (fragmented)
        left = n
        parts = []
        for i in sorted(range(self.n_nodes), key=lambda i: -self.free[i]):
            take = min(self.free[i], left)
            if take:
                self.free[i] -= take
                parts.append((i, take))
                left -= take
            if not left:
                break
        self.alloc[jid] = parts
        return self.cross_node_penalty

    def release(self, jid: int):
        for node, n in self.alloc.pop(jid, []):
            self.free[node] += n
