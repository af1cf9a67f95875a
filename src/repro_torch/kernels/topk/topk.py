"""Launch wrapper of the CUDA kernel ``csrc/topk_compress.cu``, which
replaces the Pallas kernel ``repro.kernels.topk.topk.topk_compress``
(threshold sparsify + error accumulation; the source says what bounds it
on an H100 and what its design does about it).

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on PyTorch's current stream,
raises on a launch error, and counts its launches in ``LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import segments as SG
from repro_torch.kernels.build import library

LAUNCHES = {"topk_compress": 0}


def reset_launches() -> None:
    LAUNCHES["topk_compress"] = 0


def topk_compress(g, e, threshold):
    """g fp32 [R, C] and e fp32 [R, C] or None on the card; threshold
    ``[]`` or ``[S]`` (one per R / S rows).  Returns ``(kept, new_e)`` as
    ``ref.topk_ref`` does."""
    R, C = SG.check_rows("topk_compress", g)
    if e is not None:
        SG.check("topk_compress", "e", e, (R, C), torch.float32, g.device)
    t, rows_per_segment = SG.scalars("topk_compress", threshold, R, g.device)
    out = torch.empty_like(g)
    new_e = torch.empty_like(g)
    rc = library().repro_topk_compress(
        g.data_ptr(), None if e is None else e.data_ptr(), t.data_ptr(),
        out.data_ptr(), new_e.data_ptr(), R, C, rows_per_segment,
        SG.stream(g.device))
    SG.raise_on(rc, "topk_compress")
    LAUNCHES["topk_compress"] += 1
    return out, new_e
