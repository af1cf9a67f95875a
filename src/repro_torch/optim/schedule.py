"""LR schedules (the JAX package's ``optim/schedule.py``).

A schedule maps the step count to the learning rate as a Python float
that is exactly an fp32 value: the arithmetic is fp32, in the
reference's order, on numpy ``float32`` scalars.  The one exception is
the cosine, taken in float64 of the fp32 argument and rounded to fp32:
no fp32 cosine of the host reproduces XLA's, and the correctly rounded
value lies within one fp32 ulp of it.
"""
from __future__ import annotations

import math

import numpy as np

_F32 = np.float32


def constant(lr: float):
    return lambda step: float(_F32(lr))


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    peak = _F32(peak_lr)
    warm_len = _F32(max(warmup_steps, 1))
    cos_len = _F32(max(total_steps - warmup_steps, 1))
    # the reference's Python-float factors, each rounded once to fp32
    floor, half_span = _F32(final_frac), _F32((1 - final_frac) * 0.5)

    def sched(step) -> float:
        step = _F32(step)
        if step < warmup_steps:
            return float(peak * step / warm_len)
        prog = min(max((step - _F32(warmup_steps)) / cos_len, _F32(0)),
                   _F32(1))
        cos = _F32(math.cos(float(_F32(math.pi) * prog)))
        return float(peak * (floor + half_span * (_F32(1) + cos)))
    return sched
