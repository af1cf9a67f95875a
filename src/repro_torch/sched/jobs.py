"""DL training jobs with the DL-specific structure the survey highlights
(§3.4.2): diminishing-returns loss curves, known epoch times, and
scale-out efficiency (the JAX package's ``sched/jobs.py``)."""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Job:
    jid: int
    arrival: float
    num_gpus: int                 # requested degree of data parallelism
    epochs: int
    epoch_time_1gpu: float        # seconds per epoch on 1 GPU
    scaling_alpha: float = 0.9    # parallel efficiency exponent: t = t1 / n^a
    loss0: float = 5.0
    loss_floor: float = 1.0
    loss_decay: float = 0.15      # loss(e) = floor + (l0-floor) e^{-decay e}

    # runtime state (filled by the simulator)
    start: Optional[float] = None
    finish: Optional[float] = None
    epochs_done: float = 0.0

    def epoch_time(self, n_gpus: int) -> float:
        return self.epoch_time_1gpu / (max(n_gpus, 1) ** self.scaling_alpha)

    def loss_at(self, epochs: float) -> float:
        return (self.loss_floor + (self.loss0 - self.loss_floor)
                * math.exp(-self.loss_decay * epochs))

    def marginal_progress(self) -> float:
        """Loss improvement of the next epoch — the Optimus/SLAQ quality
        signal (early epochs are worth more)."""
        return self.loss_at(self.epochs_done) - self.loss_at(self.epochs_done + 1)

    @property
    def remaining_epochs(self) -> float:
        return self.epochs - self.epochs_done

    def remaining_time(self, n_gpus: Optional[int] = None) -> float:
        return self.remaining_epochs * self.epoch_time(n_gpus or self.num_gpus)


def make_trace(n_jobs: int, n_gpus_cluster: int, seed: int = 0,
               mean_interarrival: float = 60.0) -> List[Job]:
    rng = np.random.RandomState(seed)
    jobs = []
    t = 0.0
    for j in range(n_jobs):
        t += rng.exponential(mean_interarrival)
        jobs.append(Job(
            jid=j,
            arrival=t,
            num_gpus=int(rng.choice([1, 2, 4, 8],
                                    p=[0.4, 0.3, 0.2, 0.1])),
            epochs=int(rng.randint(5, 40)),
            epoch_time_1gpu=float(rng.uniform(30, 300)),
            scaling_alpha=float(rng.uniform(0.7, 0.95)),
            loss_decay=float(rng.uniform(0.05, 0.3)),
        ))
    return jobs
