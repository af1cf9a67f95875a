"""Plain check of served tokens: the reference runs once over each sampled
request's prompt and served tokens and reads, at every position that
served a token, how far that token's logit lies below the reference's
best.  A greedy server that computes the model reads near 0; the widest
of these gaps is the number compared."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference.transformer import hidden, logits


def _served_logits(W, cfg, prompt: np.ndarray, served: Sequence[int],
                   device, lowp: Optional[str]) -> torch.Tensor:
    """Logits [n, V] at the n positions that produced the served tokens."""
    seq = np.concatenate([prompt, np.asarray(served[:-1], np.int64)])
    toks = torch.from_numpy(seq).to(device)
    h = hidden(W, cfg, toks, lowp=lowp)
    at = torch.arange(len(prompt) - 1, len(seq), device=device)
    return logits(W, cfg, h[at], lowp)


@torch.no_grad()
def gaps(W: Dict[str, torch.Tensor], cfg: Dict,
         requests: List[Tuple[np.ndarray, Sequence[int]]], device,
         control: Optional[str] = None) -> Tuple[float, int]:
    """(the widest gap over every served token of ``requests``, tokens
    read).  With ``control`` the tokens judged are not the served ones but
    those the reference computed in that lower precision puts first at
    each of the same positions."""
    widest, n = 0.0, 0
    for prompt, served in requests:
        ref = _served_logits(W, cfg, prompt, served, device, None)
        if control is None:
            tok = torch.as_tensor(np.asarray(served, np.int64), device=device)
        else:
            tok = _served_logits(W, cfg, prompt, served, device,
                                 control).argmax(-1)
        gap = ref.max(-1).values - ref.gather(1, tok[:, None])[:, 0]
        widest = max(widest, float(gap.max()))
        n += len(served)
        del ref
    return widest, n
