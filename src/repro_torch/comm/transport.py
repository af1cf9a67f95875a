"""Topology-explicit exact allreduce schedules (survey §3.3.1(2)) over the
port's worker axis.

The JAX package's ``comm/transport.py`` runs these as ``lax.ppermute``
schedules inside ``shard_map``; here a schedule takes ``x`` [n, ...]
(row ``w`` is worker ``w``'s tensor) and returns every worker's result in
the same layout, through the ``core.collectives`` index operations.  Each
hop and each addition is the reference's, in the reference's order, so
every worker's sum is rounded as on the reference; every worker ends with
the same sum.  The compressed (codec) schedules of the JAX module are
ROADMAP queue A item 4.

Per-device bytes moved for an n-worker reduce of a size-S tensor:
  ring            2 (n-1)/n S        (bandwidth-optimal)
  butterfly       log2(n) S          (recursive doubling)
  tree            2 log2(n) S        (reduce to root + broadcast)
  fully-connected (n-1) S            (every worker sends its full tensor)
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.collectives import (all_gather, axis_index, axis_size,
                                          ppermute, psum)


def _per_worker(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-worker bool [n] shaped to broadcast against ``x`` [n, ...]."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def ring_allreduce(x):
    """Bandwidth-optimal ring: reduce-scatter then all-gather, 2(n-1) steps."""
    n = axis_size(x)
    if n == 1:
        return x
    me = axis_index(x)
    flat = x.reshape(n, -1)
    L = flat.shape[1]
    m = -(-L // n)
    chunks = x.new_zeros((n, n * m))
    chunks[:, :L] = flat
    chunks = chunks.reshape(n, n, m)             # [worker, chunk, m]
    fwd = [(i, (i + 1) % n) for i in range(n)]
    for i in range(n - 1):
        recv = ppermute(chunks[me, (me - i) % n], fwd)
        dst = (me - i - 1) % n
        chunks[me, dst] = chunks[me, dst] + recv
    # rank r now owns reduced chunk (r + 1) % n
    for i in range(n - 1):
        recv = ppermute(chunks[me, (me + 1 - i) % n], fwd)
        chunks[me, (me - i) % n] = recv
    return chunks.reshape(n, -1)[:, :L].reshape(x.shape)


def butterfly_allreduce(x):
    """Recursive doubling: log2(n) exchange-and-add rounds (n power of 2)."""
    n = axis_size(x)
    if n == 1:
        return x
    if n & (n - 1):
        raise ValueError("butterfly requires power-of-two workers")
    acc = x
    for k in range(int(math.log2(n))):
        d = 1 << k
        acc = acc + ppermute(acc, [(i, i ^ d) for i in range(n)])
    return acc


def tree_allreduce(x):
    """Binomial tree: reduce to rank 0, then broadcast back down."""
    n = axis_size(x)
    if n == 1:
        return x
    levels = int(math.log2(n))
    if 1 << levels != n:
        raise ValueError("tree requires power-of-two workers")
    me = axis_index(x)
    acc = x
    # reduce phase: at level k, ranks with me % 2^(k+1) == 2^k send down
    for k in range(levels):
        d = 1 << k
        recv = ppermute(acc, [(i, i - d) for i in range(n)
                              if i % (2 * d) == d])
        acc = torch.where(_per_worker(me % (2 * d) == 0, x), acc + recv, acc)
    # broadcast phase
    for k in reversed(range(levels)):
        d = 1 << k
        recv = ppermute(acc, [(i, i + d) for i in range(n)
                              if i % (2 * d) == 0])
        acc = torch.where(_per_worker(me % (2 * d) == d, x), recv, acc)
    return acc


def fully_connected_allreduce(x):
    """Every worker sends its full tensor to every other (the O(n^2)
    traffic case the survey warns about); numerically an all_gather + sum,
    the same rows summed in the same order on every worker."""
    total = all_gather(x)[0].sum(0).to(x.dtype)
    return total[None].expand_as(x)


def psum_allreduce(x):
    return psum(x)


SCHEDULES = {
    "ring": ring_allreduce,
    "butterfly": butterfly_allreduce,
    "tree": tree_allreduce,
    "fully_connected": fully_connected_allreduce,
    "psum": psum_allreduce,
}


def pad_for_schedule(length: int, n: int) -> int:
    """Padded flat length for a chunked schedule: a whole number of 1/n
    chunks."""
    return n * (-(-length // n))
