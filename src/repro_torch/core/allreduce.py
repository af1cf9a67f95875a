"""Topology-explicit allreduce schedules (survey §3.3.1(2)): the exact
schedules of ``comm.transport`` under the names the Strategy API parses
(a topology name in a spec's arch slot means allreduce over it), and
``make_allreduce``, the reference's per-leaf front end.

The reference's schedules run inside ``shard_map`` over a named mesh
axis; here the axis is a ``core.collectives`` object: by default every
row of a leaf is a logical worker, and a ``DistAxis`` holds one worker
per ``torch.distributed`` rank.
"""
from repro_torch.comm.transport import SCHEDULES
from repro_torch.core.collectives import LogicalAxis
from repro_torch.core.tree import tree_map

TOPOLOGIES = SCHEDULES

__all__ = ["TOPOLOGIES", "make_allreduce"]


def make_allreduce(topology: str, mean: bool = True, axis=None):
    """Returns ``f(tree) -> tree``: every leaf [k, ...] (the values of the
    workers this process holds on ``axis``, stacked on dimension 0; all n
    on the default logical axis) reduced by ``topology``'s schedule, each
    worker's row the sum (or, with ``mean``, the mean) over the n workers,
    cast back to the leaf's dtype."""
    fn = TOPOLOGIES[topology]

    def reduce_tree(tree):
        def one(x):
            ax = axis if axis is not None else LogicalAxis(x.shape[0])
            y = fn(x, ax)
            if mean:
                y = y / ax.size
            return y.to(x.dtype)
        return tree_map(one, tree)

    return reduce_tree
