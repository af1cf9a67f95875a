"""Pipeline parallelism (survey §3.2.3): the GPipe micro-batch pipeline
[Huang et al., 70] and interleaved 1F1B over the logical stage axis (the
JAX package's ``core/pipeline.py``).

The reference runs the schedule inside ``shard_map`` as a ``lax.scan``
whose ticks hand activations stage to stage with ``lax.ppermute``; its
backward is the transpose of that loop.  Here the stage axis is a list
(one entry per logical stage device), a tick runs every active stage in
stage order, and a hop hands the stage's output tensor itself to the
next stage: the graph is never cut between stages, so autograd runs the
reverse pipeline and accumulates each stage's gradients over its
micro-batches.  The reference computes masked garbage on the fill and
drain ticks (its ``where`` zeroes it, gradient included); those calls
are skipped here, which changes no value.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from repro_torch.core.tree import get_path, leaf_paths, tree_map


def gpipe_forward(stage_fn: Callable, stage_params: Sequence[Any], x_micro):
    """GPipe: at tick t, stage s processes micro-batch t - s.

    stage_fn(params, x) -> y with x, y of one shape [mb, ...].
    stage_params: one entry per stage (the stage axis).
    x_micro [n_micro, mb, ...] (a tensor or a sequence of micro-batches):
    the micro-batched input, read by stage 0 only.
    Returns [n_micro, mb, ...]: the last stage's outputs.
    """
    n = len(stage_params)
    n_micro = len(x_micro)
    inbox: List[Any] = [None] * n
    outputs: List[Any] = [None] * n_micro
    for t in range(gpipe_ticks(n, n_micro)):
        sent: List[Any] = [None] * n
        for s in range(n):
            k = t - s
            if not 0 <= k < n_micro:
                continue
            y = stage_fn(stage_params[s], x_micro[k] if s == 0 else inbox[s])
            if s == n - 1:
                outputs[k] = y
            else:
                sent[s + 1] = y            # the hop to stage s + 1
        inbox = sent
    return torch.stack(outputs)


def onefb_forward(stage_fn: Callable, stage_params: Sequence[Any], x_micro,
                  interleave: int = 2):
    """Interleaved 1F1B schedule (PipeDream-flush / Megatron-style virtual
    stages).

    Each of the S stage devices holds ``interleave`` (= v) **virtual
    stages**: its stacked parameter block (leading layer dim) is split
    into v contiguous chunks of ``layers_local / v`` layers, and chunk c
    on device i is global virtual stage ``c*S + i`` (the engine lays the
    parameters out so this round-robin placement holds).  Device i
    computes (chunk c, micro k) at tick ``c*m + k + i``; activations hop
    the ring ``i -> (i+1) % S`` every tick, and the wrap link (S-1 -> 0)
    feeds a FIFO that device 0 drains m - S ticks later for the next
    chunk.  The schedule runs ``v*m + S - 1`` ticks of ``1/v`` the
    per-tick work, so the bubble fraction drops from GPipe's
    (S-1)/(m+S-1) to (S-1)/(v*m+S-1).

    Requires ``n_micro >= S`` (the wrap FIFO gap m - S must be >= 0) and
    the local layer count divisible by ``interleave``.

    stage_fn(chunk_params, x) -> y applies ONE chunk (a tree whose leaves
    have leading dim ``layers_local / v``) to x of shape [mb, ...].
    stage_params: one tree per stage device, leaves [layers_local, ...].
    Returns [n_micro, mb, ...]: the last virtual stage's outputs.
    """
    n = len(stage_params)
    v = int(interleave)
    n_micro = len(x_micro)
    if n_micro < n:
        raise ValueError(
            f"1f1b needs micro_batches >= stages (got m={n_micro} < s={n})")
    first = stage_params[0]
    layers_local = get_path(first, leaf_paths(first)[0]).shape[0]
    if layers_local % v:
        raise ValueError(
            f"local layer count {layers_local} not divisible by "
            f"interleave={v}")
    cl = layers_local // v
    chunks = [[tree_map(lambda leaf: leaf[c * cl:(c + 1) * cl], sp)
               for c in range(v)] for sp in stage_params]
    inbox: List[Any] = [None] * n
    fifo: List[Any] = [None] * n_micro
    outputs: List[Any] = [None] * n_micro
    for t in range(onefb_ticks(n, n_micro, v)):
        # the wrap link delivered stage S-1's tick-(t-1) output for
        # micro k' = (t - S) mod m: bank it first, so a gap-0 consume
        # (m == S) still sees it this tick
        if inbox[0] is not None:
            fifo[(t - n) % n_micro] = inbox[0]
        sent: List[Any] = [None] * n
        for i in range(n):
            rel = t - i
            if not 0 <= rel < v * n_micro:
                continue
            c, k = divmod(rel, n_micro)
            if i == 0:
                x_in = x_micro[k] if c == 0 else fifo[k]
            else:
                x_in = inbox[i]
            y = stage_fn(chunks[i][c], x_in)
            if i == n - 1 and c == v - 1:
                outputs[k] = y
            else:
                sent[(i + 1) % n] = y      # the ring hop
        inbox = sent
    return torch.stack(outputs)


def gpipe_ticks(n_stages: int, n_micro: int) -> int:
    """Ticks the schedule runs for: the last micro-batch enters at tick
    ``n_micro - 1`` and drains through ``n_stages - 1`` more hops.  Every
    device executes this many stage calls in the reference, so the tick
    count is also the per-stage compute (and hop) multiplier the hybrid
    engine's modeled accounting uses."""
    return n_micro + n_stages - 1


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe pipeline bubble: idle fraction of the schedule."""
    return (n_stages - 1) / gpipe_ticks(n_stages, n_micro)


def onefb_ticks(n_stages: int, n_micro: int, interleave: int = 2) -> int:
    """Interleaved-1F1B tick count: v*m chunk-calls per device plus the
    S-1 fill/drain.  Each tick costs 1/v of a GPipe tick."""
    return interleave * n_micro + n_stages - 1


def onefb_bubble_fraction(n_stages: int, n_micro: int,
                          interleave: int = 2) -> float:
    """Interleaved-1F1B bubble: (S-1)/(v*m + S-1), strictly below GPipe's
    (S-1)/(m + S-1) whenever v > 1."""
    return (n_stages - 1) / onefb_ticks(n_stages, n_micro, interleave)


def stacked_forward(stage_fn: Callable, stage_params, x_micro):
    """Unpipelined single-device reference for ``gpipe_forward``: apply
    the S stacked stages (a tree whose leaves have leading dim S) in turn
    to every micro-batch of ``x_micro`` [n_micro, mb, ...]."""
    n_stages = get_path(stage_params, leaf_paths(stage_params)[0]).shape[0]
    ys = list(x_micro)
    for s in range(n_stages):
        sp = tree_map(lambda leaf: leaf[s], stage_params)
        ys = [stage_fn(sp, y) for y in ys]
    return torch.stack(ys)
