"""Multi-tenant scheduling policies (survey §3.4.2; the JAX package's
``sched/policies.py``).

Each policy orders the waiting queue and may resize jobs:
  fifo     : arrival order (the YARN/Borg baseline)
  srtf     : shortest remaining time first
  optimus  : maximize marginal progress per GPU-second [Peng et al., 141]
  gandiva  : fifo + time-slicing oversubscription [Xiao et al., 195]
  slaq     : max-min quality fairness [Zhang et al., 205]
"""
from __future__ import annotations

from typing import List

from repro_torch.sched.jobs import Job


def fifo(queue: List[Job], now: float) -> List[Job]:
    return sorted(queue, key=lambda j: j.arrival)


def srtf(queue: List[Job], now: float) -> List[Job]:
    return sorted(queue, key=lambda j: j.remaining_time())


def optimus(queue: List[Job], now: float) -> List[Job]:
    def utility(j: Job) -> float:
        dt = j.epoch_time(j.num_gpus) * j.num_gpus   # GPU-seconds per epoch
        return -(j.marginal_progress() / max(dt, 1e-9))
    return sorted(queue, key=utility)


def slaq(queue: List[Job], now: float) -> List[Job]:
    # serve the job whose current loss is worst (max-min quality)
    return sorted(queue, key=lambda j: -j.loss_at(j.epochs_done))


POLICIES = {"fifo": fifo, "srtf": srtf, "optimus": optimus, "slaq": slaq}
GANDIVA_SLICE = 60.0   # time-slice quantum (s) for the gandiva variant
