#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches its own:

 1. device   card name and power limit (nvidia-smi), torch and CUDA
             versions; TF32 off for matmuls and cuDNN.
 2. build    compile the CUDA kernels from src/repro_torch/kernels/csrc.
 3. check    each kernel against its plain PyTorch version at the serving
             path's shapes, fp32 (<= 1e-4 abs: summation order) and bf16
             (<= 2e-2 abs: one bf16 ulp at |out| ~ 2, fp32 accumulation on
             both sides).
 4. timing   CUDA-event medians (L2 flushed before every launch) of each
             kernel, its plain version and one PyTorch library call
             (scaled_dot_product_attention, a yardstick the port never
             calls), beside the least time the card needs for the work.
 5. serve    full-width TinyLlama-1.1B in bf16 with seeded random weights:
             16 requests (prompt 512, 64 new tokens, all at t=0) through
             ServeEngine, continuous batching, paged cache (page 16),
             8 slots, max_len 576.  Launch counts are zeroed just before
             and read just after; every layer's attention must have gone
             through the kernels.
 6. path     the first prefill group and 4 decode steps again through the
             kernel path, the plain path (attn_backend="ref") in bf16, and
             the plain path in fp32.  The served tokens of those 8
             requests must equal this run's greedy tokens (same kernels,
             same shapes: a fault in the paged cache or the per-slot
             positions shows here).  The kernel path's logits must be as
             close to fp32 as the plain bf16 path's are, within a factor
             2: after 22 layers of bf16 activations the plain bf16 path is
             itself ~0.1 from fp32, so phase 3's 2e-2 per-call tolerance
             cannot hold for whole-model logits.

The last lines are the kernels JSON, the nvidia-smi line and the result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
F32_TOL, BF16_TOL = 1e-4, 2e-2
B, H, KV, HD = 8, 32, 4, 64        # TinyLlama-1.1B attention at 8 slots
PROMPT, NEW, MAX_LEN = 512, 64, 576


def phase(name):
    print(f"\n== {name}", flush=True)


def timed_ms(fn, reps=20, host_bound=False):
    """Median CUDA-event time of one call, with the L2 flushed before each
    (the serving path reaches a kernel with other layers' data in L2).

    By default the stream first sleeps ~1 ms on the card, so the call is
    queued before its start event runs: the time is the device's alone.
    ``host_bound=True`` leaves the sleep out, so a call whose launch takes
    the host longer than the device's work measures the host."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if not host_bound:
            torch.cuda._sleep(2_000_000)      # clock cycles, ~1 ms
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device on this host", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import decode_mask
    from repro_torch.models import build_model
    from repro_torch.models.transformer import tree_map
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request

    # ------------------------------------------------------------ 1 device
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ------------------------------------------------------------- 2 build
    phase("build")
    t0 = time.perf_counter()
    lib = kbuild.build()
    kbuild.library()
    print(f"built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in (kbuild.build_dir() / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    # ------------------------------------------------------------- 3 check
    phase("kernels against plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    worst = {"flash_attention": 0.0, "flash_decode": 0.0}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for S, causal, window in ((PROMPT, True, 0), (PROMPT, True, 128),
                                  (PROMPT, False, 0), (300, True, 0)):
            q = randn(B, S, H, HD, dtype=dtype)
            k, v = randn(B, S, KV, HD, dtype=dtype), randn(B, S, KV, HD,
                                                            dtype=dtype)
            e = max_err(FA.attention(q, k, v, causal=causal, window=window),
                        FA.attention_ref(q, k, v, causal=causal,
                                         window=window))
            print(f"flash_attention {str(dtype)[6:]:8s} S={S} causal={causal}"
                  f" window={window}: max_abs_err {e:.3e} (tol {tol})")
            assert e <= tol, "flash_attention disagrees with its plain version"
            worst["flash_attention"] = max(worst["flash_attention"], e)
        for L, window, pos in ((MAX_LEN, 0, [0, 17, 63, 64, 200, 300, 511, 575]),
                               (128, 128, [5, 60, 127, 128, 129, 300, 575, 1000])):
            q = randn(B, 1, H, HD, dtype=dtype)
            ck, cv = randn(B, L, KV, HD, dtype=dtype), randn(B, L, KV, HD,
                                                              dtype=dtype)
            pos = torch.tensor(pos, device=dev)
            e = max_err(FA.decode(q, ck, cv, pos, window=window),
                        FA.decode_ref(q, ck, cv, pos, window=window))
            print(f"flash_decode    {str(dtype)[6:]:8s} L={L} window={window}"
                  f" pos={pos.tolist()}: max_abs_err {e:.3e} (tol {tol})")
            assert e <= tol, "flash_decode disagrees with its plain version"
            worst["flash_decode"] = max(worst["flash_decode"], e)
    torch.cuda.synchronize()

    # ------------------------------------------------------------ 4 timing
    phase("timing (bf16, serving shapes)")
    bf = torch.bfloat16
    q, k, v = (randn(B, PROMPT, H, HD, dtype=bf),
               randn(B, PROMPT, KV, HD, dtype=bf),
               randn(B, PROMPT, KV, HD, dtype=bf))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    timing = {}

    def measure(name, kernel, plain, library, nbytes, flops):
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / BF16_FLOPS * 1e3
        t = timing[name] = dict(
            ms=timed_ms(kernel), plain_ms=timed_ms(plain),
            library_ms=timed_ms(library), bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations")
        call_ms = timed_ms(kernel, host_bound=True)
        print(f"{name}: kernel {t['ms']:.4f} ms on the device "
              f"({call_ms:.4f} ms per call when the host issues it alone), "
              f"plain {t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {nbytes} B, "
              f"{flops} FLOP)")

    measure("flash_attention",
            lambda: FA.attention(q, k, v, causal=True),
            lambda: FA.attention_ref(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            2 * (q.numel() + k.numel() + v.numel() + q.numel()),
            4 * B * H * HD * PROMPT * (PROMPT + 1) // 2)   # causal pairs

    qd = randn(B, 1, H, HD, dtype=bf)
    ck, cv = randn(B, MAX_LEN, KV, HD, dtype=bf), randn(B, MAX_LEN, KV, HD,
                                                         dtype=bf)
    pos = torch.tensor([PROMPT + 9 * b for b in range(B)], device=dev,
                       dtype=torch.int32)                # mid-serve positions
    mask = decode_mask(pos, MAX_LEN)
    keys = int(mask.sum())                               # valid cache rows
    ckt, cvt, qdt = (t.transpose(1, 2).contiguous() for t in (ck, cv, qd))
    measure("flash_decode",
            lambda: FA.decode(qd, ck, cv, pos),
            lambda: FA.decode_ref(qd, ck, cv, pos),
            lambda: F.scaled_dot_product_attention(
                qdt, ckt, cvt, attn_mask=mask[:, None, None, :],
                enable_gqa=True),
            2 * (2 * qd.numel() + 2 * keys * KV * HD) + 4 * B,
            4 * H * HD * keys)

    # ------------------------------------------------------------- 5 serve
    phase("serve full-width TinyLlama-1.1B")
    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, dtype=bf, device=dev)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B params, bf16, "
          f"init {time.perf_counter() - t0:.2f} s")
    scfg = ServeConfig(slots=8, max_len=MAX_LEN, page_size=16,
                       policy="continuous", cache_dtype=bf, compute_dtype=bf)
    prompts = np.random.RandomState(1).randint(1, cfg.vocab_size,
                                               size=(16, PROMPT))

    def requests(n, plen, new):
        return [Request(rid=i, prompt=[int(t) for t in prompts[i, :plen]],
                        max_new_tokens=new) for i in range(n)]

    ServeEngine(model, params, scfg, device=dev).run(requests(2, 16, 4))
    reqs = requests(16, PROMPT, NEW)
    eng = ServeEngine(model, params, scfg, device=dev)
    FA.reset_launches()
    m = eng.run(reqs)
    launches = dict(FA.LAUNCHES)
    print(f"{m['completed']} requests, {m['generated_tokens']} tokens in "
          f"{m['wall_s']:.3f} s wall = "
          f"{m['generated_tokens'] / m['wall_s']:.1f} tokens/s; "
          f"{m['prefill_groups']} prefill groups, {m['decode_iterations']} "
          f"decode iterations; launches {launches}")
    print(f"req 0 output[:8] = {reqs[0].output[:8]}")
    assert m["completed"] == 16 and m["generated_tokens"] == 16 * NEW
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.output)
    assert launches["flash_attention"] == m["prefill_groups"] * cfg.num_layers > 0
    assert launches["flash_decode"] == m["decode_iterations"] * cfg.num_layers > 0

    # -------------------------------------------------------------- 6 path
    phase("whole path: kernel vs plain (attn_backend='ref')")
    ref_model = build_model(dataclasses.replace(cfg, attn_backend="ref"))
    toks = torch.tensor(prompts[:8], device=dev)        # first prefill group

    def run_path(m_, p_, dtype, forced=None):
        logits, st = m_.prefill(p_, toks, compute_dtype=dtype)
        caches = m_.cache_from_prefill(st, MAX_LEN, dtype=dtype)
        out = [logits.float()]
        for step in range(4):
            tok = (forced[:, step:step + 1] if forced is not None
                   else out[-1][..., :cfg.vocab_size].argmax(-1))
            pos = torch.full((8,), PROMPT + step, device=dev)
            logits, caches = m_.decode_step(p_, caches, tok, pos,
                                            compute_dtype=dtype)
            out.append(logits.float())
        return torch.cat(out, 1)[..., :cfg.vocab_size]  # [8, 5, V]

    kern = run_path(model, params, bf)
    greedy = kern.argmax(-1)                             # [8, 5]
    ref16 = run_path(ref_model, params, bf, forced=greedy)
    p32 = tree_map(lambda t: t.float(), params)
    ref32 = run_path(ref_model, p32, torch.float32, forced=greedy)
    e_kern, e_ref16 = max_err(kern, ref32), max_err(ref16, ref32)
    agree = int((greedy == ref16.argmax(-1)).sum())
    served = int(sum(reqs[i].output[s] == int(greedy[i, s])
                     for i in range(8) for s in range(5)))
    print(f"logits max|kernel-ref bf16| {max_err(kern, ref16):.4f}; against "
          f"fp32: kernel {e_kern:.4f}, plain bf16 {e_ref16:.4f} (kernel must be"
          f" <= 2 x plain); greedy agreement kernel/plain {agree}/40; "
          f"served tokens equal to this run's greedy tokens {served}/40")
    assert torch.isfinite(kern).all()
    assert served == 40, "served tokens differ from the kernel path's greedy"
    assert e_kern <= 2 * e_ref16, "kernel path drifts from the fp32 model"

    # ------------------------------------------------------------- results
    sources = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/flash_attention.py:69"),
               "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                                "src/repro/kernels/flash_attention/flash_attention.py:160")}
    kernels = [dict(name=n, route="cuda", source=sources[n][0],
                    replaces=sources[n][1], launches=launches[n],
                    max_abs_err=worst[n], ms=timing[n]["ms"],
                    plain_ms=timing[n]["plain_ms"],
                    bound_ms=timing[n]["bound_ms"],
                    bound_by=timing[n]["bound_by"],
                    library_ms=timing[n]["library_ms"])
               for n in ("flash_attention", "flash_decode")]
    assert all(math.isfinite(x["ms"]) for x in kernels)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
