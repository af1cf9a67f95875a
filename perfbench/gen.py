"""The one traffic generator: it reads a mix file of ``perfbench/traffic``
and the run's seed and makes the inputs of a run.

Training mixes (``"kind": "train"``) feed each worker a batch per step
from a seeded noisy Markov stream over the vocabulary (next token ``(3 *
cur + 7) mod V``, a uniform draw with probability ``noise``), a function
of (seed, step, worker), so every row of every step differs.

Serving mixes (``"kind": "serve"``) make an open loop of requests: a
Poisson process at ``rate_per_s`` (gaps drawn from the seed) and prompt
and output lengths from the mix's distributions.  The lengths are the
distributions' quantiles at evenly spaced probabilities, so every seed
offers the same set of sizes, in a balanced order drawn from the seed:
any run of consecutive requests holds each part of both distributions in
its share, so the requests that a window serves, a prefix of the offers
where the queue grows, carry the same work whatever the seed.  The seed
also draws the prompts' tokens.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import Callable, Dict, List, NamedTuple

import numpy as np


# ------------------------------------------------------------- training
def markov_rows(seed: int, step: int, worker: int, rows: int, seq: int,
                vocab: int, noise: float) -> np.ndarray:
    """``rows`` sequences of ``seq + 1`` tokens, int64.  A row starts with
    a uniform draw, and each later token is one with probability
    ``noise``; ``k`` tokens after a draw ``v`` the chain stands at ``3^k v
    + 7 (3^k - 1) / 2 (mod V)``, so a row is made without a loop over its
    tokens (the feed costs the window well under a millisecond)."""
    rng = np.random.default_rng([seed, step, worker])
    n = seq + 1
    draw = rng.random((rows, n)) < noise
    draw[:, 0] = True
    fresh = rng.integers(0, vocab, size=(rows, n))
    last = np.maximum.accumulate(np.where(draw, np.arange(n), 0), axis=1)
    k = np.arange(n) - last
    pw = [1] * n
    for i in range(1, n):
        pw[i] = pw[i - 1] * 3 % vocab
    pw = np.array(pw, np.int64)
    off = 7 * (np.cumsum(pw) - pw) % vocab
    return (pw[k] * np.take_along_axis(fresh, last, axis=1) + off[k]) % vocab


def train_batches(mix: Dict, seed: int, vocab: int, device) -> Callable:
    """(step, worker) -> {"tokens", "labels"} [batch, seq] on ``device``."""
    import torch
    B, S = mix["batch_per_worker"], mix["seq_len"]
    noise = mix["stream"]["noise"]

    def batch(step: int, worker: int = 0):
        rows = torch.from_numpy(markov_rows(seed, step, worker, B, S, vocab,
                                            noise))
        return {"tokens": rows[:, :-1].to(device),
                "labels": rows[:, 1:].to(device)}
    return batch


# -------------------------------------------------------------- serving
class Offer(NamedTuple):
    due: float                 # seconds after the window opens
    prompt: np.ndarray         # int64 token ids
    max_new: int


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _lengths(spec: Dict, n: int) -> np.ndarray:
    q = _quantiles(n)
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(p) for p in q])
        x = np.round(spec["median"] * np.exp(spec["sigma"] * z))
    elif spec["dist"] == "uniform":
        x = spec["min"] + np.floor(q * (spec["max"] - spec["min"] + 1))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def max_len(mix: Dict) -> int:
    """The longest request a serving mix can make, prompt and output."""
    return mix["prompt"]["max"] + mix["output"]["max"]


def balanced_ranks(seed: int, n: int, dims: int) -> np.ndarray:
    """[n, dims] ranks, each column a permutation of ``range(n)``: the
    ranks of Roberts' R_d sequence (``u + i * alpha mod 1``, with
    ``alpha_j = g ** -(j + 1)`` for ``g`` the root of ``x ** (d + 1) = x +
    1``) from a start ``u`` drawn from the seed.  Every prefix of a column
    spreads over the whole range, and the columns are near independent."""
    g = 1.0
    for _ in range(64):
        g = (1.0 + g) ** (1.0 / (dims + 1))
    alpha = g ** -np.arange(1.0, dims + 1)
    u = np.random.default_rng([seed, 3]).random(dims)
    x = (u + np.arange(n)[:, None] * alpha) % 1.0
    return np.argsort(np.argsort(x, axis=0, kind="stable"), axis=0,
                      kind="stable")


def offers(mix: Dict, seed: int, seconds: float, vocab: int) -> List[Offer]:
    """Requests of a window of ``seconds``: Poisson arrivals drawn from
    the seed, enough of them that the process outlasts the window (those
    due after its close are never submitted), each with a size from the
    mix's fixed sets of quantiles in the seed's balanced order."""
    arr = mix["arrivals"]
    if arr["process"] != "poisson":
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    rate = arr["rate_per_s"]
    n = int(rate * seconds + 6 * (rate * seconds) ** 0.5) + 8
    rng = np.random.default_rng([seed, 1])
    due = np.cumsum(rng.exponential(1.0 / rate, n))
    ranks = balanced_ranks(seed, n, 2)
    plen = np.sort(_lengths(mix["prompt"], n))[ranks[:, 0]]
    new = np.sort(_lengths(mix["output"], n))[ranks[:, 1]]
    toks = np.random.default_rng([seed, 2])
    return [Offer(float(due[i]), toks.integers(0, vocab, size=int(plen[i])),
                  int(new[i])) for i in range(n)]
