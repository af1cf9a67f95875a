"""Serving request lifecycle (the JAX package's ``serve/request.py``).

A ``Request`` arrives at a point on the engine clock, carries its prompt
and decode budget, and moves through the state machine

    QUEUED -> PREFILL -> DECODE -> DONE

``QUEUED``   submitted, waiting for a batch slot *and* for cache pages
             (admission is reservation-based — see serve/cache.py).
``PREFILL``  admitted this iteration; its prompt runs as one batched
             forward pass that fills cache pages (never token-by-token).
``DECODE``   in a batch slot, producing one token per engine iteration.
``DONE``     reached ``max_new_tokens``; its slot and pages are recycled.

Latency accounting is on the engine's clock (virtual iteration time):
time-to-first-token is ``first_token_time - arrival`` and the per-token
latency is ``(finish_time - first_token_time) / (generated - 1)``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence

from repro_torch.obs.metrics import percentile


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (serve/sampling.py).  ``temperature <= 0``
    is greedy argmax; ``top_k`` restricts sampling to the k highest logits
    (0 = off); ``seed`` seeds the request's draws, one per token index."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


@dataclasses.dataclass
class Request:
    """One generation request moving through the serving plane."""
    rid: int
    prompt: Sequence[int]
    max_new_tokens: int
    arrival: float = 0.0
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)

    # -- lifecycle (owned by the batcher/engine) --
    state: RequestState = RequestState.QUEUED
    slot: int = -1                      # batch slot while PREFILL/DECODE
    pages: List[int] = dataclasses.field(default_factory=list)
    output: List[int] = dataclasses.field(default_factory=list)

    # -- latency accounting (engine clock) --
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    def __post_init__(self):
        if len(self.prompt) == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_len(self) -> int:
        """Context capacity the request needs: prompt + all new tokens."""
        return self.prompt_len + self.max_new_tokens

    @property
    def done(self) -> bool:
        return self.state is RequestState.DONE

    def first_token_latency(self) -> float:
        """Time-to-first-token on the engine clock (inf if never served)."""
        if self.first_token_time is None:
            return float("inf")
        return self.first_token_time - self.arrival

    def per_token_latency(self) -> float:
        """Steady-state decode latency per generated token."""
        if self.finish_time is None or self.first_token_time is None:
            return float("inf")
        n = len(self.output)
        if n <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (n - 1)


def summarize(requests: Sequence[Request], makespan: float) -> dict:
    """Aggregate serving metrics over completed requests: throughput plus
    p50/p99 first-token and per-token latencies."""
    done = [r for r in requests if r.done]
    total_tokens = sum(len(r.output) for r in done)
    ttft = [r.first_token_latency() for r in done]
    tpot = [r.per_token_latency() for r in done]
    return {
        "completed": len(done),
        "generated_tokens": total_tokens,
        "tokens_per_s": total_tokens / makespan if makespan > 0 else 0.0,
        "p50_first_token": percentile(ttft, 50),
        "p99_first_token": percentile(ttft, 99),
        "p50_per_token": percentile(tpot, 50),
        "p99_per_token": percentile(tpot, 99),
    }
