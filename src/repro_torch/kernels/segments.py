"""Shared pieces of the per-segment elementwise kernels (``topk``,
``terngrad``, ``qsgd``): the per-segment view their plain versions take,
and the operand checks and launch plumbing of their CUDA wrappers.

A per-segment scalar (a threshold, a scale, a norm) is a tensor of shape
``[]`` (one segment: the whole ``[R, C]`` block, the compressor's per-leaf
case) or ``[S]`` (S segments of R / S consecutive rows each: one per worker
when a segment codec encodes every worker's payload in one call).
"""
from __future__ import annotations

from typing import Tuple

import torch


def by_segment(x: torch.Tensor, per_segment) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``x`` [R, C] as [S, R / S, C] beside ``per_segment`` as [S, 1, 1]."""
    v = torch.as_tensor(per_segment, dtype=torch.float32, device=x.device)
    if v.dim() > 1 or x.shape[0] % v.numel():
        raise ValueError(f"per-segment scalars of shape {tuple(v.shape)} do "
                         f"not split {x.shape[0]} rows")
    S = v.numel()
    return x.reshape(S, -1, x.shape[-1]), v.reshape(S, 1, 1)


def per_segment(reduce, x: torch.Tensor) -> torch.Tensor:
    """``reduce(t, dim)`` of each row of ``x`` [S, L]: [S].  Each row is
    reduced by a launch of its own, so a segment's bits do
    not depend on how many segments ``x`` holds (CUDA splits a reduction
    across blocks by the whole launch's shape, so row r of an [S, L]
    reduction can round otherwise than the same row alone: a process
    holding one worker's segment must get the logical axis's bits)."""
    return torch.stack([reduce(row, dim=0) for row in x])


def check(kernel: str, name: str, t: torch.Tensor, shape, dtype, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(
            shape):
        raise ValueError(
            f"{kernel}: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def check_rows(kernel: str, g: torch.Tensor) -> Tuple[int, int]:
    """``g`` must be a non-empty contiguous fp32 [R, C] CUDA tensor."""
    if g.device.type != "cuda" or g.dim() != 2 or g.numel() == 0:
        raise ValueError(f"{kernel}: g must be a non-empty 2-d CUDA tensor, "
                         f"got {tuple(g.shape)} on {g.device}")
    check(kernel, "g", g, g.shape, torch.float32, g.device)
    return g.shape


def scalars(kernel: str, v, rows: int,
            device: torch.device) -> Tuple[torch.Tensor, int]:
    """Per-segment scalars as a contiguous fp32 [S] vector on ``device``
    and the rows per segment."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    if v.numel() == 0 or rows % v.numel():
        raise ValueError(f"{kernel}: {v.numel()} segments do not split "
                         f"{rows} rows")
    return v.contiguous(), rows // v.numel()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
