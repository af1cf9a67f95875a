"""Pipeline parallelism (survey §3.2.3): the GPipe micro-batch pipeline
[Huang et al., 70] and interleaved 1F1B over the logical stage axis (the
JAX package's ``core/pipeline.py``).

The reference runs the schedule inside ``shard_map`` as a ``lax.scan``
whose ticks hand activations stage to stage with ``lax.ppermute``; its
backward is the transpose of that loop.  Here ``schedule_table`` lists
every stage call of either schedule by (device, tick), with the call its
input comes from and the call its output goes to, and one walker runs it
forward.  The reference computes masked garbage on the fill and drain
ticks (its ``where`` zeroes it, gradient included); those calls are not
in the table, which changes no value.

``gpipe_forward`` and ``onefb_forward`` walk the table with the stage
axis a list (one entry per logical stage device) and hand each stage's
output tensor itself to the next stage: the graph is never cut between
stages, so autograd runs the reverse pipeline and accumulates each
stage's gradients over its micro-batches.

``pipeline_step`` walks the same table with the graph cut at every hop,
so each stage device can live in a process of its own: the forward hands
each activation on (a copy over a ``DistAxis`` of the stage line, or the
tensor itself), the loss is taken on the last stage, and the backward
walks the ticks in reverse, each device back-propagating its own calls
one at a time and handing each input's cotangent back to the device that
produced it.  A device's parameter gradients so accumulate in one fixed
order, its calls' reverse tick order, whether its neighbours run in the
same process or not: the hybrid engine's logical and per-rank stage axes
give the same bits.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.core.tree import get_path, leaf_paths, tree_map


def gpipe_forward(stage_fn: Callable, stage_params: Sequence[Any], x_micro):
    """GPipe: at tick t, stage s processes micro-batch t - s
    (``schedule_table``'s "gpipe" walked forward, the graph uncut).

    stage_fn(params, x) -> y with x, y of one shape [mb, ...].
    stage_params: one entry per stage (the stage axis).
    x_micro [n_micro, mb, ...] (a tensor or a sequence of micro-batches):
    the micro-batched input, read by stage 0 only.
    Returns [n_micro, mb, ...]: the last stage's outputs.
    """
    n = len(stage_params)
    outputs, _ = _forward(schedule_table(n, len(x_micro)),
                          lambda i, c, x: stage_fn(stage_params[i], x),
                          range(n), x_micro, cut=False)
    return torch.stack(outputs)


def onefb_forward(stage_fn: Callable, stage_params: Sequence[Any], x_micro,
                  interleave: int = 2):
    """Interleaved 1F1B schedule (PipeDream-flush / Megatron-style virtual
    stages): ``schedule_table``'s "1f1b" walked forward, the graph uncut.

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
    outputs, _ = _forward(schedule_table(n, n_micro, "1f1b", v),
                          lambda i, c, x: stage_fn(chunks[i][c], x),
                          range(n), x_micro, cut=False)
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


# ---------------------------------------------------- cut-graph schedule
def schedule_table(stages: int, micro: int, schedule: str = "gpipe",
                   interleave: int = 1) -> Dict[Tuple[int, int], dict]:
    """Every stage call of the schedule, keyed by (device, tick):
    ``chunk``, ``micro``, where its input comes from (``("x", k)`` the
    micro-batch, or ``("dev", device, tick)`` the producing call) and
    where its output goes (``("out", k)`` the loss head, or ``("dev",
    device, tick)`` the consuming call).  GPipe: device s computes micro
    t - s at tick t.  Interleaved 1F1B: device i computes (chunk c, micro
    k) at tick ``c*m + k + i`` and the wrap link S-1 -> 0 feeds chunk
    c + 1 (``onefb_forward``)."""
    S, m = stages, micro
    v = interleave if schedule == "1f1b" else 1
    ticks = onefb_ticks(S, m, v) if schedule == "1f1b" else \
        gpipe_ticks(S, m)
    table: Dict[Tuple[int, int], dict] = {}
    for t in range(ticks):
        for i in range(S):
            rel = t - i
            if not 0 <= rel < v * m:
                continue
            c, k = divmod(rel, m)
            if i == 0:
                src = ("x", k) if c == 0 else \
                    ("dev", S - 1, (c - 1) * m + k + S - 1)
            else:
                src = ("dev", i - 1, t - 1)
            if i == S - 1:
                dst = ("out", k) if c == v - 1 else ("dev", 0, (c + 1) * m + k)
            else:
                dst = ("dev", i + 1, t + 1)
            table[i, t] = dict(chunk=c, micro=k, src=src, dst=dst)
    return table


def _peers(table, me: int, t: int, forward: bool):
    """Device ``me``'s hop at tick ``t`` on a stage axis: (the device it
    sends to or None, the device it receives from or None, the producing
    call the received tensor belongs to).  Forward, an output goes to its
    consumer; backward, an input's cotangent goes back to its producer."""
    end = "dst" if forward else "src"
    rec = table.get((me, t))
    dst = (rec[end][1] if rec is not None and rec[end][0] == "dev"
           else None)
    for (j, tt), r in table.items():
        if tt == t and r[end][0] == "dev" and r[end][1] == me:
            return dst, j, ((j, t) if forward else r[end][1:])
    return dst, None, None


def _forward(table, call: Callable, held: Sequence[int], x_micro,
             axis=None, cut: bool = True):
    """The forward half of a ``schedule_table`` over the devices held:
    each call's input is micro-batch k on device 0, else its producer's
    output, handed on within the process or over ``axis`` (one device per
    rank) tick by tick.  ``cut``: a received activation becomes a leaf
    of a new graph (``pipeline_step``'s backward walks the calls); else
    autograd sees one graph through every stage.  Returns the last
    virtual stage's outputs by micro-batch (None on the ranks that do not
    hold the last device) and each call's (cut input or None, output) by
    (device, tick)."""
    ticks = max(t for _, t in table) + 1
    like = x_micro[0]
    held = list(held)
    # activations in flight, by the call that produced them
    acts: Dict[Tuple[int, int], torch.Tensor] = {}
    done: Dict[Tuple[int, int], Tuple[Any, Any]] = {}
    outputs: List[Any] = [None] * len(x_micro)
    for t in range(ticks):
        y_out = None
        for i in held:
            rec = table.get((i, t))
            if rec is None:
                continue
            src = rec["src"]
            x_in = None
            if src[0] != "x":
                x_in = acts.pop(src[1:])
                if cut:
                    x_in = x_in.detach().requires_grad_()
            y = call(i, rec["chunk"], x_micro[src[1]] if x_in is None
                     else x_in)
            done[i, t] = (x_in if cut else None, y)
            if rec["dst"][0] == "out":
                outputs[rec["micro"]] = y
            else:
                acts[i, t] = y_out = y
        if axis is not None:
            dst, src, key = _peers(table, held[0], t, forward=True)
            got = axis.sendrecv(y_out if dst is not None else None, dst,
                                like if src is not None else None, src)
            acts.pop((held[0], t), None)
            if got is not None:
                acts[key] = got
        del y_out
    return outputs, done


def pipeline_step(call: Callable, held: Sequence[int], x_micro,
                  loss_fn: Callable, *, stages: int,
                  schedule: str = "gpipe", interleave: int = 1,
                  axis=None):
    """One forward and backward of the schedule over the stage devices
    this process holds (``held``: all S, or its own on a stage axis).

    ``call(device, chunk, x) -> y`` runs one chunk of a device's layers
    on an activation; its parameters are leaves that accumulate ``.grad``.
    ``x_micro[k]`` is micro-batch k, read by device 0.  ``loss_fn(ys) ->
    (loss, total)`` takes the last virtual stage's outputs (one per
    micro-batch, leaves of a cut graph) on the last device, and
    ``total.backward()`` gives their cotangents.  ``axis`` is the stage
    line's ``core.collectives.DistAxis`` (worker = stage) when each
    device is a rank (``held`` its own); None when this process holds
    every device.  Returns the loss on the last device's holder, else
    None."""
    S, m = stages, len(x_micro)
    table = schedule_table(S, m, schedule, interleave)
    ticks = max(t for _, t in table) + 1
    like = x_micro[0]
    held = list(held)
    outputs, done = _forward(table, call, held, x_micro, axis)
    # cotangents in flight, by the call that produced the activation
    cots: Dict[Tuple[int, int], torch.Tensor] = {}
    loss = None
    if S - 1 in held:
        ys = [y.detach().requires_grad_() for y in outputs]
        loss, total = loss_fn(ys)
        total.backward()
        for (i, t), rec in table.items():
            if i == S - 1 and rec["dst"][0] == "out":
                cots[i, t] = ys[rec["micro"]].grad
        del ys, total
    del outputs
    for t in reversed(range(ticks)):
        g_out = None
        for i in reversed(held):
            if (i, t) not in done:
                continue
            x_in, y = done.pop((i, t))
            torch.autograd.backward(y, cots.pop((i, t)))
            del y
            if x_in is not None:
                cots[table[i, t]["src"][1:]] = g_out = x_in.grad
        if axis is not None:
            dst, src, key = _peers(table, held[0], t, forward=False)
            got = axis.sendrecv(g_out if dst is not None else None, dst,
                                like if src is not None else None, src)
            if dst is not None:
                cots.pop(table[held[0], t]["src"][1:], None)
            if got is not None:
                cots[key] = got
        del g_out
    return loss
