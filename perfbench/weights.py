"""Seeded weights, made on the device in the dtype they are served or
trained in.  Each weight has a generator of its own, seeded from the run's
seed and the weight's index, so any single weight can be made again later
(the training check re-makes the starting weights one at a time instead of
keeping a copy).  Draws: embedding N(0, 0.02), dense N(0, 1/fan_in),
output head N(0, 1/d), norm gains 1 + N(0, 0.02), biases N(0, 0.02)."""
from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference.transformer import weight_specs

_MIX = 0x9E3779B97F4A7C15


def _seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + index * _MIX) % (2 ** 63)


def make_one(cfg, seed: int, index: int, dtype, device) -> torch.Tensor:
    name, shape, kind = weight_specs(cfg)[index]
    return _draw(shape, kind, _seed(seed, index), dtype, device)


def _draw(shape, kind, seed, dtype, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if kind == "dense":
        return w.mul_(1.0 / math.sqrt(shape[0]))
    w.mul_(0.02)
    return w.add_(1.0) if kind == "scale" else w


def make(cfg, seed: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Every weight of ``cfg``, by name."""
    return {name: _draw(shape, kind, _seed(seed, i), dtype, device)
            for i, (name, shape, kind) in enumerate(weight_specs(cfg))}

