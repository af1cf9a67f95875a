"""Launch wrapper of the CUDA kernel ``csrc/qsgd_compress.cu``, which
replaces the Pallas kernel ``repro.kernels.qsgd.qsgd.qsgd_compress``
(s-level stochastic quantization; the source says what bounds it on an
H100 and what its design does about it).  The l2 norm is a reduction
taken here, outside the kernel, as in JAX.

The wrapper checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches on PyTorch's current stream, raises
on a launch error, and counts its launches in ``LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import segments as SG
from repro_torch.kernels.build import library
from repro_torch.kernels.qsgd.ref import l2_norms

LAUNCHES = {"qsgd_compress": 0}


def reset_launches() -> None:
    LAUNCHES["qsgd_compress"] = 0


def qsgd_compress(g, u, s_levels: int = 127, segments: int = 1):
    """g, u fp32 [R, C] on the card -> (levels int8 [R, C], norm) as
    ``ref.qsgd_ref``."""
    R, C = SG.check_rows("qsgd_compress", g)
    SG.check("qsgd_compress", "u", u, (R, C), torch.float32, g.device)
    norm = l2_norms(g, segments)
    nv, rows_per_segment = SG.scalars("qsgd_compress", norm, R, g.device)
    out = torch.empty((R, C), dtype=torch.int8, device=g.device)
    rc = library().repro_qsgd_compress(
        g.data_ptr(), u.data_ptr(), nv.data_ptr(), out.data_ptr(), R, C,
        rows_per_segment, int(s_levels), SG.stream(g.device))
    SG.raise_on(rc, "qsgd_compress")
    LAUNCHES["qsgd_compress"] += 1
    return out, norm
