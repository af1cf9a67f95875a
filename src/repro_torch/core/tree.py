"""Nests of dicts, lists and tuples of tensors (the port's parameter and
gradient trees), and ``LeafLayout``: the JAX package's leaf list over
such a tree.

The JAX package plans, compresses and reduces gradients leaf by leaf in
``jax.tree.leaves`` order: dict keys sorted, sequences in order.  Its
decoder stacks the layers of a scan segment into one leaf per parameter
kind (``wq`` as ``[layers, d, d]``), where the port keeps one dict per
layer.  A ``LeafLayout`` names, for each of the reference's leaves, the
tensors of a port tree it is made of (several: stacked on a new leading
axis), so the data-parallel engine can work on the reference's leaves in
the reference's order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Sequence, Tuple

import torch

Path = Tuple[Any, ...]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every leaf of a nest of dicts, lists and tuples
    (with the matching leaves of ``rest``, trees of the same structure,
    as further arguments)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaf_paths(tree, prefix: Path = ()) -> List[Path]:
    """Paths of the leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k],
                                                            prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, prefix + (i,))]
    return [prefix]


def get_path(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def set_path(tree, path: Path, value) -> None:
    get_path(tree, path[:-1])[path[-1]] = value


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """The reference's leaves over a port tree (module docstring).

    ``parts[i]`` lists the paths of leaf i's tensors in the port tree: one
    path is the tensor itself, several are stacked on a new axis 0.
    ``stacked[i]`` (when given) stacks leaf i even from one part: a scan
    segment of one group, whose reference leaf has a leading axis of 1."""
    names: Tuple[str, ...]
    parts: Tuple[Tuple[Path, ...], ...]
    stacked: Tuple[bool, ...] = ()

    def is_stacked(self, i: int) -> bool:
        return len(self.parts[i]) > 1 or bool(self.stacked
                                                and self.stacked[i])

    @classmethod
    def of_tree(cls, tree) -> "LeafLayout":
        """One leaf per tensor, in ``jax.tree.leaves`` order: the layout of
        a tree that has no stacked segments."""
        paths = leaf_paths(tree)
        return cls(tuple("/".join(map(str, p)) for p in paths),
                   tuple((p,) for p in paths))

    def shapes(self, tree) -> List[Tuple[int, ...]]:
        out = []
        for i, paths in enumerate(self.parts):
            shape = tuple(get_path(tree, paths[0]).shape)
            out.append((len(paths),) + shape if self.is_stacked(i) else shape)
        return out

    def leaf(self, tree, i: int) -> torch.Tensor:
        """Leaf ``i`` of ``tree``, its parts stacked (a copy when there
        are several)."""
        ts = [get_path(tree, p) for p in self.parts[i]]
        return torch.stack(ts) if self.is_stacked(i) else ts[0]

    def view(self, tree) -> "LeafView":
        """The leaves of ``tree`` as a sequence stacked on each read."""
        return LeafView(self, tree)

    def leaves(self, tree, consume: bool = False) -> Iterator[torch.Tensor]:
        """Yield each leaf, stacking its parts.  ``consume=True`` drops the
        parts from ``tree`` as they are read, so a gradient tree's memory
        goes as its stacked leaves are made."""
        for i, paths in enumerate(self.parts):
            ts = [get_path(tree, p) for p in paths]
            if consume:
                for p in paths:
                    set_path(tree, p, None)
            leaf = torch.stack(ts) if self.is_stacked(i) else ts[0]
            del ts
            yield leaf
            del leaf

    def update(self, tree, leaves: Sequence[torch.Tensor],
               fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
        """A new tree whose tensors are ``fn(tensor, its slice of the
        leaf)``; ``tree`` itself is left as it was."""
        out = tree_map(lambda t: t, tree)
        for i, (paths, leaf) in enumerate(zip(self.parts, leaves)):
            for j, p in enumerate(paths):
                part = leaf[j] if self.is_stacked(i) else leaf
                set_path(out, p, fn(get_path(tree, p), part))
        return out


class LeafView:
    """A tree's leaves as a lazily stacked sequence: item ``i`` is
    ``layout.leaf(tree, i)``, made on each read, so a consumer that reads
    leaves bucket by bucket holds one stacked copy at a time.  Assigning
    to an item does nothing (``CommPlan`` drops the leaves it consumed by
    assigning None)."""

    def __init__(self, layout: LeafLayout, tree):
        self.layout = layout
        self.tree = tree

    def __len__(self) -> int:
        return len(self.layout.parts)

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.layout.leaf(self.tree, i)

    def __setitem__(self, i: int, value) -> None:
        pass
