"""Long-context serving on the port's continuous-batching engine: a dense
arch's full KV cache against a sliding-window cache and the
constant-state recurrent families (the long_500k configuration at a
small scale), then the paged pool serving the same tokens (the JAX
package's examples/serve_longcontext.py).

  PYTHONPATH=src python tools/torch_serve_longcontext.py [--device cpu]
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.cache import cache_bytes  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402

B, PROMPT, NEW = 2, 24, 24


def run(arch: str, device, window: int = 0, page_size: int = 0):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device=device)
    prompts = np.random.RandomState(1).randint(1, cfg.vocab_size,
                                               size=(B, PROMPT))
    reqs = [Request(rid=i, prompt=[int(t) for t in prompts[i]],
                    max_new_tokens=NEW) for i in range(B)]
    eng = ServeEngine(model, params, ServeConfig(
        slots=B, max_len=PROMPT + NEW, page_size=page_size,
        window_override=window), device=device)
    m = eng.run(reqs)
    nbytes = cache_bytes(eng.kv.store)
    label = arch + (f" (window={window})" if window else "") \
        + (f" (pages={page_size})" if page_size else "")
    print(f"{label:42s} {m['wall_s']:5.1f}s  cache={nbytes / 1e6:7.2f} MB  "
          f"sample={reqs[0].output[:8]}")
    return nbytes, [r.output for r in reqs]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    print("arch (decode mode)                          time   cache")
    full, toks_full = run("tinyllama-1.1b", dev)          # full KV cache
    swa, _ = run("tinyllama-1.1b", dev, window=8)         # sliding window
    ssm, _ = run("rwkv6-7b", dev)                         # constant state
    run("recurrentgemma-9b", dev)                         # RG-LRU + local
    _, toks_paged = run("tinyllama-1.1b", dev, page_size=8)   # paged pool
    assert swa <= full and ssm < full
    assert toks_paged == toks_full, "paged layout changed tokens"
    print("\nsliding-window and recurrent caches do not grow with the "
          "context;\nthe paged pool serves the same tokens as the full "
          "cache.")


if __name__ == "__main__":
    main()
