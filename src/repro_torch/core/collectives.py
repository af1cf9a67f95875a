"""The port's worker-axis seam: K logical workers as dimension 0 of a
tensor, in one process.

The JAX package runs its collective schedules inside ``shard_map``, one
program per device, with ``lax.ppermute`` / ``axis_index`` / ``psum`` over
a named axis.  Here every collective takes and returns a tensor whose row
``w`` is worker ``w``'s value, and is an index operation over that row
dimension.  The schedules in ``comm.transport`` are written against these
with the JAX package's hop order, so each worker's sums are taken in the
reference's order.  This runs on the CPU and on one card; a
``torch.distributed`` backend behind the same functions is later work.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def axis_size(x: torch.Tensor) -> int:
    return x.shape[0]


def axis_index(x: torch.Tensor) -> torch.Tensor:
    """Each worker's index, [n] on ``x``'s device."""
    return torch.arange(x.shape[0], device=x.device)


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: worker ``dst`` receives worker ``src``'s row for
    every ``(src, dst)`` in ``perm``; a worker that receives nothing gets
    zeros."""
    src = [s for s, _ in perm]
    dst = [d for _, d in perm]
    out = torch.zeros_like(x)
    out[dst] = x[src]
    return out


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``lax.all_gather``: every worker holds every row, [n, n, ...]."""
    return x[None].expand((x.shape[0],) + tuple(x.shape))


def psum(x: torch.Tensor) -> torch.Tensor:
    """``lax.psum``: every worker holds the sum over workers, taken in
    worker order."""
    acc = x[0].clone()
    for w in range(1, x.shape[0]):
        acc += x[w]
    return acc[None].expand_as(x)


def psum_scatter(x) -> torch.Tensor:
    """``lax.psum_scatter(x, scatter_dimension=0, tiled=False)``: ``x[w]``
    is worker w's ``[n, m]`` contribution (``x`` a ``[n, n, m]`` tensor or
    a sequence of n such tensors); worker r receives the worker-order sum
    of chunk r, so the result is ``[n, m]``.  A worker that contributes
    nothing may pass a zero view (``t.new_zeros(()).expand(n, m)``): the
    sum then adds exact zeros and holds no copy of them."""
    acc = x[0].clone(memory_format=torch.contiguous_format)
    for w in range(1, len(x)):
        acc += x[w]
    return acc
