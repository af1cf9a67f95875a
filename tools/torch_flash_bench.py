"""Time the port's flash kernels on the GPU at the serving path's shapes.

bf16 prefill (B=8, S=512, TinyLlama-1.1B's 32 query / 4 KV heads of dim
64, causal), bf16 decode at 8 slots against a 576-row cache (positions
512-575, the serving smoke's) and against a 2048-row cache (TinyLlama's
full context, positions 1984-2047), and the fp32 training forward (B=2,
S=256).  Each line gives the kernel's CUDA-event median (L2 flushed before
every launch), one PyTorch library call computing the same function
(scaled_dot_product_attention, a yardstick the port never calls) and the
least time the card needs for the work, as one JSON object.  The fp32
forward's bound is its route's: 3 TF32 tensor-core products per fp32
product (3xTF32).

    PYTHONPATH=src python tools/torch_flash_bench.py [--src DIR]

``--src`` imports ``repro_torch`` from another checkout's ``src`` (an
older commit unpacked beside this one), so two versions can be timed on
one card in one call.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
TF32_FLOPS = 495e12                # dense TF32 tensor-core peak
B, H, KV, HD = 8, 32, 4, 64        # TinyLlama-1.1B attention at 8 slots


def timed_ms(fn, reps=50):
    """Median CUDA-event time of one call, L2 flushed before each; the
    stream sleeps first so the call is queued before its start event."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes, flops, peak):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import decode_mask

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def report(name, kernel, library, nbytes, flops, peak=BF16_FLOPS):
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        print(json.dumps(dict(name=name, src=args.src, ms=timed_ms(kernel),
                              library_ms=timed_ms(library), bound_ms=b_ms,
                              bound_by=b_by, card=card)), flush=True)

    # (dtype, S, batch, name, tensor-core products per product, peak)
    for dtype, S, Bq, name, products, peak in (
            (torch.bfloat16, 512, B, "flash_attention", 1, BF16_FLOPS),
            (torch.float32, 256, 2, "flash_attention_train", 3, TF32_FLOPS)):
        q, k, v = (randn(Bq, S, H, HD, dtype=dtype),
                   randn(Bq, S, KV, HD, dtype=dtype),
                   randn(Bq, S, KV, HD, dtype=dtype))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        size = q.element_size()
        report(f"{name} {str(dtype)[6:]} B={Bq} S={S}",
               lambda: FA.attention(q, k, v, causal=True),
               lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True),
               size * (2 * q.numel() + k.numel() + v.numel()),
               products * 4 * Bq * H * HD * S * (S + 1) // 2, peak)

    for L in (576, 2048):
        qd = randn(B, 1, H, HD)
        ck, cv = randn(B, L, KV, HD), randn(B, L, KV, HD)
        first = 512 if L == 576 else L - 64
        pos = torch.tensor([first + 9 * b for b in range(B)], device=dev,
                           dtype=torch.int32)
        mask = decode_mask(pos, L)
        keys = int(mask.sum())
        qdt, ckt, cvt = (t.transpose(1, 2).contiguous() for t in (qd, ck, cv))
        report(f"flash_decode bf16 B={B} L={L} pos {first}-{first + 63}",
               lambda: FA.decode(qd, ck, cv, pos),
               lambda: F.scaled_dot_product_attention(
                   qdt, ckt, cvt, attn_mask=mask[:, None, None, :],
                   enable_gqa=True),
               2 * (2 * qd.numel() + 2 * keys * KV * HD) + 4 * B,
               4 * H * HD * keys)
    return 0


if __name__ == "__main__":
    sys.exit(main())
