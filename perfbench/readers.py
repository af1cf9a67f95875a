"""Arithmetic the per-layer metric readers share: the model's matmul
parameters and FLOPs, and a kernel's roofline share from the trace."""
from __future__ import annotations

from typing import Optional

from perfbench.reference.transformer import dims
from perfbench.trace import kernel_time


def matmul_params(cfg) -> tuple:
    """(matmul weights of the decoder layers, of the output head)."""
    m = dims(cfg)
    d, q, kv = m["d"], m["H"] * m["hd"], m["KV"] * m["hd"]
    layer = 2 * d * q + 2 * d * kv + 3 * d * m["ff"]
    return m["L"] * layer, d * m["V"]


def train_flops_per_token(cfg, seq: int) -> float:
    """6 N + 12 L d S (the PaLM count: forward and backward of every
    matmul weight, and of attention over the sequence)."""
    m = dims(cfg)
    n = sum(matmul_params(cfg))
    return 6.0 * n + 12.0 * m["L"] * m["H"] * m["hd"] * seq


def prefill_flops(cfg, S: int) -> float:
    """A prompt of S tokens: every layer weight for each token, the output
    head for the last, attention over the S (S + 1) / 2 attended pairs."""
    m = dims(cfg)
    layers, head = matmul_params(cfg)
    return 2.0 * layers * S + 2.0 * head \
        + 4.0 * m["L"] * m["H"] * m["hd"] * S * (S + 1) / 2


def decode_flops(cfg, length: int) -> float:
    """One decoded token whose row attends to ``length`` cached positions."""
    m = dims(cfg)
    return 2.0 * sum(matmul_params(cfg)) \
        + 4.0 * m["L"] * m["H"] * m["hd"] * length


def roofline_pct(run, names, bound_s_per_launch) -> Optional[float]:
    """100 x the least time of the launches the trace holds of kernels
    ``names`` over their time; ``bound_s_per_launch(launches)`` gives the
    least time of that many launches, or None when the launches do not
    match what the harness's records say ran."""
    if run.trace is None:
        return None
    seconds, launches = kernel_time(run.trace,
                                    lambda n: any(k in n for k in names))
    if not launches or seconds <= 0:
        return None
    bound = bound_s_per_launch(launches)
    return None if bound is None else 100.0 * bound / seconds
