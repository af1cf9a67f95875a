"""Adam / AdamW, with optionally quantized (bf16) EMA moment buffers (the
JAX package's ``optim/adam.py``).

The step is the reference's, operation for operation: the EMAs and the
update in fp32 (bf16 moments are widened on read and rounded back on
store), the bias corrections ``1 - b^t`` in fp32 from the integer step,
``u = (m / c1) / (sqrt(v / c2) + eps)``, and ``weight_decay * p`` added
to the normalised update.  ``torch.optim.Adam(weight_decay=)`` adds the
decay to the gradient instead, which is another function.

The update runs tensor by tensor, in place (``torch.optim``'s idiom: a
full-width model's parameters and moments are not copied), with the
reference's roundings: its temporaries are one tensor's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.tree import get_path, leaf_paths, tree_map
from repro_torch.optim.sgd import apply_update

_F32 = np.float32


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 sqrt, as XLA's: CUDA's ``sqrtf`` is; the
    CPU's vectorised fp32 sqrt is not, so the CPU takes it in float64 (one
    rounding to fp32 of a correctly rounded double is correctly rounded)."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


def _scalar(x: float, device) -> torch.Tensor:
    """``x`` as an fp32 scalar tensor on ``device``: CUDA divides by a
    Python number as a product with its reciprocal, by a device tensor as
    an IEEE division, which is the reference's.  ``torch.full`` fills on
    the device; ``torch.tensor`` would copy from the host and make the
    stream wait."""
    return torch.full((), x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Adam:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    # storage dtype of the m/v EMA buffers ("float32" | "bfloat16");
    # EMA/update arithmetic is always fp32
    moment_dtype: str = "float32"

    # moment buffers per parameter (what ZeRO-1/2 shard away)
    moments_per_param = 2

    @property
    def mdt(self) -> torch.dtype:
        return getattr(torch, self.moment_dtype)

    @property
    def moment_bytes(self) -> int:
        """Bytes per stored moment element (4 fp32, 2 bf16)."""
        return torch.finfo(self.mdt).bits // 8

    def init(self, params, layout=None):
        """Zero moments shaped like ``params``; ``t`` is the step count.
        ``layout`` is accepted for the optimizers' one interface (the
        update is elementwise)."""
        z = lambda p: torch.zeros_like(p, dtype=self.mdt)
        return {"m": tree_map(z, params), "v": tree_map(z, params), "t": 0}

    def step(self, params, grads, state, lr: float, layout=None):
        """Update ``params`` and ``state`` in place; returns them."""
        t = state["t"] + 1
        b1, b2 = self.b1, self.b2
        c1 = float(_F32(1) - _F32(b1) ** _F32(t))
        c2 = float(_F32(1) - _F32(b2) ** _F32(t))
        paths = leaf_paths(params)
        dev = get_path(params, paths[0]).device
        c1, c2 = _scalar(c1, dev), _scalar(c2, dev)
        for path in paths:
            p, g, m, v = (get_path(x, path) for x in (params, grads,
                                                      state["m"], state["v"]))
            g = g.float()
            m32, v32 = m.float(), v.float()    # the buffers when fp32
            m32.mul_(b1).add_((1 - b1) * g)
            v32.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            u = (m32 / c1).div_(_sqrt(v32 / c2).add_(self.eps))
            if self.weight_decay:
                u.add_(self.weight_decay * p.float())
            apply_update(p, u.mul_(lr))
            if m32 is not m:                   # rounded back on store
                m.copy_(m32)
                v.copy_(v32)
        state["t"] = t
        return params, state


def AdamW(weight_decay: float = 0.01, **kw) -> Adam:
    return Adam(weight_decay=weight_decay, **kw)
