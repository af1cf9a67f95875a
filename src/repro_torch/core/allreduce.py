"""Topology-explicit allreduce schedules (survey §3.3.1(2)): the exact
schedules of ``comm.transport`` under the names the Strategy API parses
(a topology name in a spec's arch slot means allreduce over it), and
``make_allreduce``, the reference's per-leaf front end.

The reference's schedules run inside ``shard_map`` over a named mesh
axis; the port's workers are logical and stacked on dimension 0 of each
tensor, so ``make_allreduce`` takes no ``axis_name``.
"""
from repro_torch.comm.transport import SCHEDULES
from repro_torch.core.tree import tree_map

TOPOLOGIES = SCHEDULES

__all__ = ["TOPOLOGIES", "make_allreduce"]


def make_allreduce(topology: str, mean: bool = True):
    """Returns ``f(tree) -> tree``: every leaf [n, ...] (the n workers'
    values stacked on dimension 0) reduced by ``topology``'s schedule,
    each worker's row the sum (or, with ``mean``, the mean) over the
    workers, cast back to the leaf's dtype."""
    fn = TOPOLOGIES[topology]

    def reduce_tree(tree):
        def one(x):
            y = fn(x)
            if mean:
                y = y / x.shape[0]
            return y.to(x.dtype)
        return tree_map(one, tree)

    return reduce_tree
