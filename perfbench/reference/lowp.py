"""The lower precisions of the correctness controls, applied to a matrix
product's operands: ``tf32`` keeps 10 of fp32's 23 mantissa bits (rounded
to nearest, ties away from zero, as the tensor cores convert), ``fp8``
scales the whole operand so its largest magnitude is fp8 e4m3's largest
finite value (448) and rounds to e4m3.  Products then accumulate in fp32,
as the lower-precision paths of the card do.  Under autograd the rounding
passes gradients straight through, so a training control rounds the
operands of its forward products and of the backward's products that
reuse them."""
from __future__ import annotations

from typing import Optional

import torch

FORMATS = ("tf32", "fp8")
E4M3_MAX = 448.0


def round_operand(x: torch.Tensor, lowp: Optional[str]) -> torch.Tensor:
    if lowp is None:
        return x
    x = x.float()
    with torch.no_grad():
        if lowp == "tf32":
            bits = x.detach().contiguous().view(torch.int32)
            r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        elif lowp == "fp8":
            scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
            r = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        else:
            raise ValueError(f"lowp={lowp!r} not in {FORMATS}")
    return x + (r - x).detach() if x.requires_grad else r
