"""The flash kernels at the shapes of the recurrent and encoder-decoder
families, checked and timed on the GPU in under a minute.

Builds the kernels, prints the flash kernels' registers and spills
(``-Xptxas -v``), holds ``flash_attention`` (bf16 and fp32) and
``flash_decode`` against their plain versions at head_dim 256
(RecurrentGemma-9B's local attention: 16 query heads on one KV head,
window 2048, prefill past the window, ring decode at positions up to
3000), at Whisper-large-v3's encoder shape (non-causal, S 1500, a tail
tile) and its decoder's (causal, S 448), with the tolerances of
``chip_smoke.py`` (fp32 1e-4, bf16 2e-2), then times four of them beside
``scaled_dot_product_attention`` and the plain version (CUDA-event
medians, L2 flushed).  The last line lists the cases that failed.

    PYTHONPATH=src python tools/torch_hd256_check.py
"""
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print("card:", smi, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    kbuild.build()
    kbuild.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, regs, spills in C.kernel_resources(
            (kbuild.build_dir() / "build.log").read_text()):
        if "flash" in name:
            print(f"  {name}: {regs} registers, {spills}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    bad = []
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        cases = [(1, 300, 16, 1, 256, True, 0), (2, 100, 8, 2, 256, True, 16),
                 (1, 512, 16, 1, 256, True, 2048),
                 (1, 512, 16, 1, 256, False, 0),
                 (1, 700, 16, 1, 256, True, 128)]
        if dtype == torch.bfloat16:
            cases += [(1, 2560, 16, 1, 256, True, 2048),
                      (1, 2560, 16, 1, 256, True, 0)]
        cases += [(4, 1500, 20, 20, 64, False, 0), (2, 448, 20, 20, 64, True, 0)]
        for Bq, S, H, KV, hd, causal, window in cases:
            big = (dtype == torch.float32 and hd == 256 and S == 512
                   and causal)
            for scale in ((1.0, 4.0) if big else (1.0,)):
                q = randn(Bq, S, H, hd, dtype=dtype) * scale
                k = randn(Bq, S, KV, hd, dtype=dtype) * scale
                v = randn(Bq, S, KV, hd, dtype=dtype)
                out = FA.attention(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                e = C.max_err(out, FA.attention_ref(q, k, v, causal=causal,
                                                    window=window))
                ok = e <= tol
                print(f"prefill {str(dtype)[6:]} B={Bq} S={S} H={H} KV={KV} "
                      f"hd={hd} causal={causal} W={window} x{scale}: {e:.3e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    bad.append(("prefill", str(dtype), S, hd))
        for Bd, L, H, KV, hd, window, pos in (
                (8, 2048, 16, 1, 256, 2048,
                 [100, 500, 2047, 2048, 2049, 2300, 2900, 3000]),
                (8, 2048, 16, 1, 256, 0, [0, 63, 64, 700, 1023, 1500, 2047, 2100]),
                (4, 448, 20, 20, 64, 0, [0, 17, 300, 447]),
                (3, 200, 8, 2, 256, 200, [3, 199, 517])):
            q = randn(Bd, 1, H, hd, dtype=dtype)
            ck, cv = (randn(Bd, L, KV, hd, dtype=dtype),
                      randn(Bd, L, KV, hd, dtype=dtype))
            p = torch.tensor(pos, device=dev)
            out = FA.decode(q, ck, cv, p, window=window)
            torch.cuda.synchronize()
            e = C.max_err(out, FA.decode_ref(q, ck, cv, p, window=window))
            ok = e <= tol and bool(torch.isfinite(out).all())
            print(f"decode {str(dtype)[6:]} B={Bd} L={L} H={H} KV={KV} hd={hd} "
                  f"W={window}: {e:.3e} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                bad.append(("decode", str(dtype), L, hd))

    bf = torch.bfloat16
    q, k, v = (randn(1, 2560, 16, 256, dtype=bf),
               randn(1, 2560, 1, 256, dtype=bf), randn(1, 2560, 1, 256, dtype=bf))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    i = torch.arange(2560, device=dev)
    mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - 2048)
    print("prefill bf16 hd256 W2048: kernel",
          C.timed_ms(lambda: FA.attention(q, k, v, window=2048)), "sdpa",
          C.timed_ms(lambda: F.scaled_dot_product_attention(
              qt, kt, vt, attn_mask=mask, enable_gqa=True)),
          "plain", C.timed_ms(lambda: FA.attention_ref(q, k, v, window=2048)),
          flush=True)
    f32 = torch.float32
    q, k, v = (randn(1, 512, 16, 256, dtype=f32),
               randn(1, 512, 1, 256, dtype=f32), randn(1, 512, 1, 256, dtype=f32))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    print("prefill f32 hd256 S512: kernel",
          C.timed_ms(lambda: FA.attention(q, k, v)), "sdpa",
          C.timed_ms(lambda: F.scaled_dot_product_attention(
              qt, kt, vt, is_causal=True, enable_gqa=True)), flush=True)
    qd = randn(8, 1, 16, 256, dtype=bf)
    ck, cv = randn(8, 2048, 1, 256, dtype=bf), randn(8, 2048, 1, 256, dtype=bf)
    pos = torch.tensor([100 + 414 * b for b in range(8)], device=dev,
                       dtype=torch.int32)
    print("decode bf16 hd256 ring: kernel",
          C.timed_ms(lambda: FA.decode(qd, ck, cv, pos, window=2048)),
          flush=True)
    q, k, v = (randn(4, 1500, 20, 64, dtype=bf) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    print("whisper enc bf16: kernel",
          C.timed_ms(lambda: FA.attention(q, k, v, causal=False)), "sdpa",
          C.timed_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
          flush=True)
    print("BAD", bad, f"total {time.perf_counter() - t0:.1f} s")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
