"""Communication scheduling (survey §3.3.3(3)): TicTac / Bösen style
transfer ordering + bucketing, as an analytic timeline model.

The port's own copy of the JAX package's ``core/comm_scheduler.py`` (plain
Python, unchanged): given per-layer backward compute times and gradient
sizes, it computes iteration time with no overlap (all communication at
the end) or with bucketed overlap in a chosen transfer order.
``comm.plan.CommPlan`` builds its bucket plan and issue order from these
primitives.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence


@dataclasses.dataclass(frozen=True)
class LinkModel:
    alpha_s: float = 5e-6        # per-message latency (s)
    beta_Bps: float = 50e9       # link bandwidth (B/s)

    def time(self, nbytes: float) -> float:
        return self.alpha_s + nbytes / self.beta_Bps


@dataclasses.dataclass(frozen=True)
class LayerCost:
    name: str
    back_compute_s: float        # backward compute time producing this grad
    grad_bytes: float


def schedule_no_overlap(layers: Sequence[LayerCost], link: LinkModel) -> float:
    compute = sum(l.back_compute_s for l in layers)
    comm = sum(link.time(l.grad_bytes) for l in layers)
    return compute + comm


def schedule_overlap(layers: Sequence[LayerCost], link: LinkModel,
                     order: Sequence[int]) -> float:
    """Backward runs layer L-1 .. 0; gradient i becomes available when its
    layer's backward finishes.  Transfers run on one link in `order`
    (indices into layers), each starting when both the link is free and the
    gradient is ready.  Returns iteration time (last transfer completion)."""
    L = len(layers)
    avail = {}
    t = 0.0
    for i in reversed(range(L)):         # backward pass order
        t += layers[i].back_compute_s
        avail[i] = t
    link_free = 0.0
    done = 0.0
    for i in order:
        start = max(link_free, avail[i])
        link_free = start + link.time(layers[i].grad_bytes)
        done = max(done, link_free)
    return done


def bucketize(layers: Sequence[LayerCost], bucket_bytes: float
              ) -> List[LayerCost]:
    """Fuse consecutive (in backward order) gradients into buckets — the
    latency-vs-overlap trade-off every data-parallel framework tunes."""
    out: List[LayerCost] = []
    cur_names, cur_comp, cur_bytes = [], 0.0, 0.0
    for l in reversed(list(layers)):     # backward order
        cur_names.append(l.name)
        cur_comp += l.back_compute_s
        cur_bytes += l.grad_bytes
        if cur_bytes >= bucket_bytes:
            out.append(LayerCost("+".join(cur_names), cur_comp, cur_bytes))
            cur_names, cur_comp, cur_bytes = [], 0.0, 0.0
    if cur_names:
        out.append(LayerCost("+".join(cur_names), cur_comp, cur_bytes))
    return list(reversed(out))           # back to forward order


def tictac_order(layers: Sequence[LayerCost]) -> List[int]:
    """Transfer earliest-ready gradients first (reverse layer order) — the
    TicTac-optimal order for a chain model."""
    return list(reversed(range(len(layers))))


def random_order(layers: Sequence[LayerCost], seed: int = 0) -> List[int]:
    import random
    idx = list(range(len(layers)))
    random.Random(seed).shuffle(idx)
    return idx
