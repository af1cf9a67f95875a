"""Deterministic synthetic LM data with sharded loading and prefetch (the
JAX package's ``data/pipeline.py``).

The token stream is the JAX package's numpy stream, bit for bit: a noisy
Markov chain over the vocab (``next = (3 * cur + 7) % V`` with 10% noise)
drawn from a ``RandomState`` seeded by (seed, step, worker), so batches
are a pure function of (step, worker) and workers get non-overlapping
chunks.  Batches come back as int32 tensors on the caller's device.
The reference's ``LMDataConfig.markov_order`` is not ported: it is
declared there and never read (the chain is always first order).

``ShardedLoader`` prefetches batches on a background thread into a
bounded queue; ``EpochCache`` materializes one epoch and serves the rest
from memory (survey §3.5.1, Hoard [142]).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

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


class ShardedLoader:
    """Background-prefetching loader over a deterministic batch function:
    a reader thread fills a bounded queue (the "data server" of Project
    Adam / Facebook's preprocessing tier) while the trainer consumes.
    Iteration ends after ``num_steps`` batches (never, if None)."""

    def __init__(self, batch_fn: Callable[[int], Any], prefetch: int = 4,
                 num_steps: Optional[int] = None):
        self._fn = batch_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._num = num_steps
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = 0
        while not self._stop.is_set():
            if self._num is not None and step >= self._num:
                self._q.put(None)
                return
            self._q.put(self._fn(step))
            step += 1

    def __iter__(self) -> Iterator[Any]:
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def close(self):
        """Stop the reader: it finishes the batch it is making, and the
        queue is drained so a blocked ``put`` returns."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class EpochCache:
    """Hoard-style [142] local cache: materialize one epoch once, serve all
    subsequent epochs (and co-scheduled jobs) from memory."""

    def __init__(self, batch_fn: Callable[[int], Any], steps_per_epoch: int):
        self._fn = batch_fn
        self._steps = steps_per_epoch
        self._cache: Dict[int, Any] = {}

    def __call__(self, step: int):
        k = step % self._steps
        if k not in self._cache:
            self._cache[k] = self._fn(k)
        return self._cache[k]

    @property
    def hit_ratio_after(self):
        """The number of batches materialized (the reference's name)."""
        return len(self._cache)
