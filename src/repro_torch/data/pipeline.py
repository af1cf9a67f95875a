"""Deterministic synthetic LM data (the JAX package's ``data/pipeline.py``,
stream part).

The token stream is the JAX package's numpy stream, bit for bit: a noisy
Markov chain over the vocab (``next = (3 * cur + 7) % V`` with 10% noise)
drawn from a ``RandomState`` seeded by (seed, step, worker), so batches
are a pure function of (step, worker) and workers get non-overlapping
chunks.  Batches come back as int32 tensors on the caller's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int = 512
    seq_len: int = 128
    batch_size: int = 8
    seed: int = 0


def _markov_tokens(rng: np.random.RandomState, cfg: LMDataConfig,
                   n_rows: int) -> np.ndarray:
    """Noisy deterministic chain: next = (3 * cur + 7) % V with eps noise."""
    V = cfg.vocab_size
    toks = np.empty((n_rows, cfg.seq_len + 1), dtype=np.int32)
    cur = rng.randint(0, V, size=n_rows)
    for t in range(cfg.seq_len + 1):
        toks[:, t] = cur
        noise = rng.random(n_rows) < 0.1
        nxt = (3 * cur + 7) % V
        cur = np.where(noise, rng.randint(0, V, size=n_rows), nxt)
    return toks


def synthetic_lm_batch(cfg: LMDataConfig, step: int, worker: int = 0,
                       device="cpu") -> Dict[str, torch.Tensor]:
    rng = np.random.RandomState((cfg.seed * 1_000_003 + step) * 31 + worker)
    toks = torch.from_numpy(_markov_tokens(rng, cfg, cfg.batch_size))
    return {"tokens": toks[:, :-1].to(device),
            "labels": toks[:, 1:].to(device)}


def make_lm_batches(cfg: LMDataConfig, device="cpu"
                    ) -> Callable[[int, int], Dict[str, torch.Tensor]]:
    """(step, worker) -> batch on ``device``."""
    return lambda step, worker=0: synthetic_lm_batch(cfg, step, worker,
                                                     device)
