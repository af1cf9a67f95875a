"""Public entries of the flash-attention kernels.

``attention`` and ``decode`` check device, dtype, shape and contiguity,
then dispatch on the tensors' device: a CUDA tensor launches the CUDA
kernel (or raises), a CPU tensor takes the plain PyTorch version.
``attention_grad`` is the trainable entry the model routes through: its
forward is the flash kernel and its backward replays the plain version
(``attention_ref``) under autograd, as the JAX package's custom VJP does,
so gradients are the reference math's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import on_card
from repro_torch.kernels.flash_attention.flash_attention import (
    DTYPE_CODES, LAUNCHES, flash_attention, flash_decode, reset_launches)
from repro_torch.kernels.flash_attention.ref import attention_ref, decode_ref

HEAD_DIMS = (32, 64, 128, 256)


def _check(q, kv, what: str) -> None:
    tensors = (q, *kv)
    if any(t.dim() != 4 for t in tensors):
        raise ValueError(f"{what}: want 4-d tensors, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if kv[0].shape != kv[1].shape or kv[0].shape[0] != q.shape[0]:
        raise ValueError(f"{what}: k/v shapes {tuple(kv[0].shape)}, "
                         f"{tuple(kv[1].shape)} do not fit q {tuple(q.shape)}")
    H, KV, hd = q.shape[2], kv[0].shape[2], q.shape[3]
    if kv[0].shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"{what}: {KV} KV heads of dim {kv[0].shape[3]} "
                         f"cannot serve {H} query heads of dim {hd}")
    if len({t.device for t in tensors}) != 1 or len(
            {t.dtype for t in tensors}) != 1:
        raise ValueError(f"{what}: q, k, v must share one device and dtype")
    if q.device.type != "cuda":
        return
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: kernel takes {list(DTYPE_CODES)}, "
                         f"got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: kernel needs contiguous, 16-byte "
                             "aligned tensors")


def _flash(q, k, v, causal: bool, window: int):
    """The prefill kernel; on ``meta`` (``backend.meta_as_card``) its
    output's shape, which is all it allocates."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    return flash_attention(q, k, v, causal=causal, window=window)


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, S, H, hd]; k, v [B, S, KV, hd] (KV divides H) -> [B, S, H, hd].
    ``window`` applies only with ``causal`` (as in the Pallas kernel)."""
    _check(q, (k, v), "attention")
    if k.shape[1] != q.shape[1]:
        raise ValueError("attention: q and k/v need one sequence length")
    window = window if causal else 0
    if on_card(q):
        return _flash(q, k, v, causal, window)
    return attention_ref(q, k, v, causal=causal, window=window)


class _AttentionGrad(torch.autograd.Function):
    """Flash forward on the card; the backward differentiates
    ``attention_ref`` on the saved q, k, v (there is no backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _flash(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_ref(*qkv, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, qkv, grad)
        return dq, dk, dv, None, None


def attention_grad(q, k, v, *, causal: bool = True, window: int = 0):
    """``attention`` that autograd can differentiate: on the card the flash
    kernel's output with the plain version's gradients; on the CPU the
    plain version itself."""
    _check(q, (k, v), "attention_grad")
    if k.shape[1] != q.shape[1]:
        raise ValueError("attention_grad: q and k/v need one sequence length")
    window = window if causal else 0
    if on_card(q):
        return _AttentionGrad.apply(q, k, v, causal, window)
    return attention_ref(q, k, v, causal=causal, window=window)


def decode(q, ck, cv, pos, *, window: int = 0):
    """q [B, 1, H, hd]; ck, cv [B, L, KV, hd]; pos [B] int (each row's own
    position) -> [B, 1, H, hd]."""
    _check(q, (ck, cv), "decode")
    if q.shape[1] != 1 or pos.shape != (q.shape[0],):
        raise ValueError(f"decode: want q [B,1,H,hd] and pos [B], got "
                         f"{tuple(q.shape)} and {tuple(pos.shape)}")
    if q.device.type == "meta" and on_card(q):
        return torch.empty_like(q)          # the kernel's output shape
    if on_card(q):
        pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
        return flash_decode(q, ck, cv, pos, window=window)
    return decode_ref(q, ck, cv, pos, window=window)


__all__ = ["LAUNCHES", "attention", "attention_grad", "attention_ref",
           "decode", "decode_ref", "reset_launches"]
