"""SGD with (Nesterov) momentum (the JAX package's ``optim/sgd.py``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import get_path, leaf_paths, tree_map


def apply_update(p: torch.Tensor, upd: torch.Tensor) -> None:
    """``p <- p - upd`` in place, taken in fp32 and rounded once to
    ``p``'s dtype (the reference's ``(p32 - lr * u).astype(p.dtype)``;
    ``upd`` holds ``lr * u``)."""
    if p.dtype == torch.float32:
        p.sub_(upd)
    else:
        p.copy_(p.float() - upd)


@dataclasses.dataclass(frozen=True)
class SGD:
    momentum: float = 0.9
    nesterov: bool = False

    def init(self, params, layout=None):
        """``layout`` is accepted for the optimizers' one interface; the
        update is elementwise, so it does not depend on it."""
        if self.momentum == 0:
            return {}
        return {"m": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def step(self, params, grads, state, lr: float, layout=None):
        """Update ``params`` and ``state`` in place; returns them."""
        mom = self.momentum
        for path in leaf_paths(params):
            g = get_path(grads, path).float()
            if mom == 0:
                upd = g
            else:
                m = get_path(state["m"], path)
                m.mul_(mom).add_(g)
                upd = mom * m + g if self.nesterov else m
            apply_update(get_path(params, path), lr * upd)
        return params, state
