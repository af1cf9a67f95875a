"""Batch ``generate`` over the serving engine (the JAX package's
``serve/serve_loop.py``).

The prompt runs as one batched prefill (``Model.prefill`` +
``cache_from_prefill``) and decode proceeds through ``ServeEngine``'s
step under the one-shot policy, the cache in the compute dtype.
``greedy_sample`` is re-exported from ``serve/sampling.py``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.serve.sampling import greedy_sample  # noqa: F401


def generate(model, params, prompt, max_new_tokens: int,
             max_len: Optional[int] = None, window_override: int = 0,
             compute_dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Greedy decode.  ``prompt`` [B, S0] (array, list or tensor) ->
    [B, S0 + max_new_tokens] int64 on ``device``, where ``params`` must
    live."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request

    if isinstance(prompt, torch.Tensor):
        prompt = prompt.cpu().numpy()
    prompt = np.asarray(prompt, np.int64)
    B, S0 = prompt.shape
    max_len = max_len or (S0 + max_new_tokens)
    eng = ServeEngine(model, params, ServeConfig(
        slots=B, max_len=max_len, policy="oneshot",
        cache_dtype=compute_dtype, compute_dtype=compute_dtype,
        window_override=window_override), device=device)
    reqs = [Request(rid=i, prompt=[int(t) for t in prompt[i]],
                    max_new_tokens=max_new_tokens) for i in range(B)]
    eng.run(reqs)
    out = np.concatenate(
        [prompt, np.array([r.output for r in reqs], np.int64)], axis=1)
    return torch.from_numpy(out).to(eng.device)
