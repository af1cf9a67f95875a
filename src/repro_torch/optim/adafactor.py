"""Adafactor (factored second moments; the JAX package's
``optim/adafactor.py``): optimizer state of O(rows + cols) per matrix
instead of O(rows * cols).

Which moments are factored and the RMS clip of the update depend on the
whole leaf, so the step runs over the reference's leaves
(``core.tree.LeafLayout``: a model's stacked layer parameters are one
leaf there, and a stacked norm scale is a matrix).  The state's ``f`` is
a list in the layout's leaf order.  The step writes the new parameters
into ``params`` in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.tree import LeafLayout, get_path

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class Adafactor:
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0

    def init(self, params, layout: LeafLayout = None):
        layout = layout or LeafLayout.of_tree(params)
        dev = get_path(params, layout.parts[0][0]).device

        def one(shape):
            z = lambda s: torch.zeros(s, dtype=torch.float32, device=dev)
            if len(shape) >= 2:
                return {"vr": z(shape[:-1]), "vc": z(shape[:-2] + shape[-1:])}
            return {"v": z(shape)}
        return {"f": [one(s) for s in layout.shapes(params)], "t": 0}

    def _one(self, p, g, st, beta: float, lr: float):
        eps = self.eps
        g32 = g.float()
        g2 = torch.square(g32) + eps
        if p.dim() >= 2:
            vr = beta * st["vr"] + (1 - beta) * g2.mean(-1)
            vc = beta * st["vc"] + (1 - beta) * g2.mean(-2)
            denom = torch.clamp_min(vr.mean(-1, keepdim=True), eps)
            prec = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            u = g32 * torch.rsqrt(prec + eps)
            new_st = {"vr": vr, "vc": vc}
        else:
            v = beta * st["v"] + (1 - beta) * g2
            u = g32 * torch.rsqrt(v + eps)
            new_st = {"v": v}
        # update clipping (RMS over the whole leaf)
        rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
        u = u / torch.clamp_min(rms / self.clip_threshold, 1.0)
        return (p.float() - lr * u).to(p.dtype), new_st

    def step(self, params, grads, state, lr: float,
             layout: LeafLayout = None):
        """Update ``params`` and ``state`` in place; returns them."""
        layout = layout or LeafLayout.of_tree(params)
        t = state["t"] + 1
        beta = float(_F32(1) - (_F32(t) + _F32(1)) ** _F32(-self.decay))
        for i, paths in enumerate(layout.parts):
            new, state["f"][i] = self._one(
                layout.leaf(params, i), layout.leaf(grads, i),
                state["f"][i], beta, lr)
            for j, path in enumerate(paths):
                get_path(params, path).copy_(new[j] if layout.is_stacked(i)
                                             else new)
        state["t"] = t
        return params, state
