"""Launch wrappers of the CUDA flash-attention kernels.

``csrc/flash_attention.cu`` replaces the Pallas kernel
``repro.kernels.flash_attention.flash_attention.flash_attention`` (prefill)
and ``csrc/flash_decode.cu`` replaces ``flash_decode`` (one-token decode);
each source says what bounds it on an H100 and what its design does about
it.  These wrappers take CUDA tensors that ``ops`` has validated, launch on
PyTorch's current stream, raise on any launch error, and count their
launches in ``LAUNCHES`` so a run can show it went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import library

LAUNCHES = {"flash_attention": 0, "flash_decode": 0}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def decode_chunk(B: int, L: int, KV: int, sms: int | None = None,
                 row_bytes: int = 0) -> int:
    """Cache rows per block of the split-K decode: a multiple of 16 in
    [16, 128], small enough that the (chunk, KV head, batch row) grid runs
    about two blocks on each of ``sms`` SMs (by default the current CUDA
    device's).  At the serving shape (B=8, L=576, KV=4) on an H100's 132
    SMs: 64 rows, 9 x 4 x 8 = 288 blocks.  Cache rows of more than 512
    bytes (``row_bytes``: fp32 at head_dim 256) take at most 64, so a
    block's K and V chunks fit in shared memory."""
    if sms is None:
        sms = torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    splits = -(-2 * sms // (B * KV))
    chunk = -(-L // splits)
    return max(16, min(128 if row_bytes <= 512 else 64,
                       -(-chunk // 16) * 16))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, S, H, hd]; k, v [B, S, KV, hd] on the card -> [B, S, H, hd]."""
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    rc = library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
        k.shape[2], hd, int(causal), int(window), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o


def flash_decode(q, ck, cv, pos, *, window: int = 0):
    """q [B, 1, H, hd]; ck, cv [B, L, KV, hd]; pos int32 [B], all on the
    card -> [B, 1, H, hd].  Two kernels (the split-K pass and its combine),
    one launch counted; their fp32 partials go to a scratch tensor."""
    B, _, H, hd = q.shape
    L, KV = ck.shape[1], ck.shape[2]
    chunk = decode_chunk(B, L, KV, row_bytes=hd * q.element_size())
    part = torch.empty(B * H * -(-L // chunk) * (hd + 2), dtype=torch.float32,
                       device=q.device)
    o = torch.empty_like(q)
    rc = library().repro_flash_decode(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(),
        o.data_ptr(), part.data_ptr(), B, L, H, KV, hd, int(window), chunk,
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return o
