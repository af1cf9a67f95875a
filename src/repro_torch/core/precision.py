"""Mixed-precision policy (survey §3.3.3(1), Gupta et al. [55]; the JAX
package's ``core/precision.py``).

params_dtype: storage; compute_dtype: matmul/activations; reduce_dtype:
gradients on the wire.  Stochastic rounding (Gupta et al.'s key finding)
is provided for low-precision parameter updates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.tree import tree_map


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _cast(tree, dtype: torch.dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    params_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    reduce_dtype: str = "float32"

    @property
    def pdt(self) -> torch.dtype:
        return _dtype(self.params_dtype)

    @property
    def cdt(self) -> torch.dtype:
        return _dtype(self.compute_dtype)

    @property
    def rdt(self) -> torch.dtype:
        return _dtype(self.reduce_dtype)

    def cast_for_compute(self, tree):
        return _cast(tree, self.cdt)

    def cast_for_reduce(self, tree):
        return _cast(tree, self.rdt)


def stochastic_round(x: torch.Tensor, target_dtype: torch.dtype,
                     gen: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unbiased rounding to a lower-precision float (Gupta et al. [55]).

    Nudges the nearest-rounded value one target-dtype ulp toward x with
    probability |x - round(x)| / ulp, so E[out] == x.  ``u`` are the
    uniform draws in [0, 1) (shaped like ``x``), drawn from ``gen`` when
    not given."""
    x = x.float()
    lo32 = x.to(target_dtype).float()
    f = torch.finfo(target_dtype)
    # ulp of the target dtype at lo32's binade
    step = (2.0 ** torch.floor(torch.log2(torch.clamp_min(lo32.abs(),
                                                          float(f.tiny))))
            * float(f.eps))
    delta = x - lo32
    frac = torch.clamp(delta.abs() / step, 0.0, 1.0)
    if u is None:
        u = torch.rand(x.shape, generator=gen, device=x.device)
    out = torch.where(u < frac, lo32 + torch.sign(delta) * step, lo32)
    return out.to(target_dtype)


DEFAULT = PrecisionPolicy()
FP32 = PrecisionPolicy("float32", "float32", "float32")
BF16_COMPUTE = PrecisionPolicy("float32", "bfloat16", "float32")
BF16_REDUCE = PrecisionPolicy("float32", "bfloat16", "bfloat16")
BF16_EVERYTHING = PrecisionPolicy("bfloat16", "bfloat16", "bfloat16")

# Strategy-level precision names (the mesh-suffix tokens): master weights
# stay fp32 in every named policy — "bf16" is cast-for-compute with fp32
# updates, "bf16r" additionally reduces gradients in bf16 on the wire.
POLICIES = {"fp32": FP32, "bf16": BF16_COMPUTE, "bf16r": BF16_REDUCE}


def policy_for(name: str) -> PrecisionPolicy:
    """Resolve a Strategy/mesh-suffix precision name to its policy."""
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown precision {name!r} (want one of {sorted(POLICIES)})")
