"""Token sampling for the serving plane (the JAX package's
``serve/sampling.py``).

``greedy_sample`` is the argmax over the unpadded vocab (ties go to the
first index, as in ``jnp.argmax``).  ``sample_tokens`` adds temperature /
top-k sampling with one ``torch.Generator`` per sampling slot, seeded from
the request's seed and the token index, so a request's draws do not
depend on which slot or iteration served it.  These draws are not
``jax.random``'s: only the greedy path is token-for-token comparable
across the two packages.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def greedy_sample(logits, vocab_size: int):
    """argmax over the un-padded vocab.  logits [B, 1, Vpad]."""
    return logits[..., :vocab_size].argmax(dim=-1)


def request_generator(seed: int, token_index: int, device) -> torch.Generator:
    """The generator of one request's draw at one token index."""
    mixed = ((int(seed) & 0xFFFFFFFF) << 32) | (int(token_index) & 0xFFFFFFFF)
    return torch.Generator(device=device).manual_seed(mixed)


def sample_tokens(logits, vocab_size: int, seeds, token_index, temperature,
                  top_k):
    """Per-slot sampling.  logits [B, Vpad]; seeds, token_index,
    temperature, top_k: host arrays [B].  Slots with ``temperature <= 0``
    return the greedy argmax; the rest draw from the temperature-scaled,
    top-k-filtered categorical with their own generator.  Returns [B]
    int64 on the logits' device."""
    lg = logits[..., :vocab_size].float()
    out = greedy_sample(lg, vocab_size)
    for i in np.flatnonzero(np.asarray(temperature) > 0):
        row = lg[i]
        scaled = row / max(float(temperature[i]), 1e-6)
        if top_k[i] > 0:
            k = int(min(max(int(top_k[i]), 1), vocab_size))
            thresh = torch.topk(row, k).values[-1]
            scaled = torch.where(row >= thresh, scaled, NEG_INF)
        gen = request_generator(seeds[i], token_index[i], lg.device)
        out[i] = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                   generator=gen)[0]
    return out
