"""Plain data-parallel exchange of K logical workers' gradients: the
bucketed ring mean-allreduce, full precision or with 1-bit encoding and
error feedback inside the ring (Seide et al.), as the survey's
compressed synchronous data parallelism specifies it and the benchmark's
training cells configure it.

The gradients travel as one leaf list in the order of a JAX parameter
tree (dict keys sorted, the layers of the decoder stacked into one leaf
per parameter kind).  Leaves are fused into buckets of at least
``bucket_mb`` in backward order, each bucket's leaves concatenated last
leaf first.  A bucket is reduced as one flat vector, zero-padded to a
whole number of 1/K chunks:

* ``none``: a ring reduce-scatter then all-gather, sums in ring order,
  divided by K;
* ``onebit``: each worker first compensates its gradient with its
  residual, ``c = g + gain * e``; every reduce-scatter hop and the
  owner's final broadcast encode a chunk as signs plus two means per
  256-element row (the mean of the positive and of the negative values),
  and the receiver adds the decoded chunk; the quantization error of
  each encode, and ``(g + e) - c``, make the worker's next residual.

Everything here is written from that description in plain ``torch``."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.transformer import dims

LANE = 256
EF_GAIN = 2.0

# a decoder layer's weights by their key path in the JAX tree
_LAYER_PATH = {"ln1.scale": "ln1/scale", "ln1.bias": "ln1/bias",
               "ln2.scale": "ln2/scale", "ln2.bias": "ln2/bias",
               "wq": "mixer/wq/w", "wk": "mixer/wk/w", "wv": "mixer/wv/w",
               "wo": "mixer/wo/w", "bq": "mixer/wq/b", "bk": "mixer/wk/b",
               "bv": "mixer/wv/b", "w_gate": "mlp/w_gate/w",
               "w_up": "mlp/w_up/w", "w_down": "mlp/w_down/w"}


def leaf_order(cfg: Dict, names: Sequence[str]) -> List[List[str]]:
    """The JAX tree's leaves over the weight names ``names``: each leaf is
    the list of names it stacks (one name for an unstacked leaf)."""
    L = dims(cfg)["L"]
    top = {n: n.replace(".", "/") for n in names if not n.startswith("layers.")}
    per_layer = sorted({n.split(".", 2)[2] for n in names
                        if n.startswith("layers.")}, key=_LAYER_PATH.get)
    keyed = [(path, [n]) for n, path in top.items()]
    keyed += [("segments/0/0/" + _LAYER_PATH[k],
               [f"layers.{i}.{k}" for i in range(L)]) for k in per_layer]
    return [leaf for _, leaf in sorted(keyed)]


def bucket_plan(numels: Sequence[int], bucket_mb: float = 4.0
                ) -> List[List[int]]:
    """Leaf indices of each bucket, fused in backward order until a bucket
    holds ``bucket_mb`` MB of fp32, each bucket's indices last leaf
    first."""
    out, cur, size = [], [], 0
    for i in reversed(range(len(numels))):
        cur.append(i)
        size += 4 * numels[i]
        if size >= bucket_mb * 1e6:
            out.append(cur)
            cur, size = [], 0
    if cur:
        out.append(cur)
    return out[::-1]


def _onebit(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [K, m] -> (decoded [K, m], quantization error x - decoded): signs
    (>= 0 is +) and, per 256-element row, the mean of the positive values
    and of the negated negative ones over the row's real elements."""
    K, m = x.shape
    pad = (-m) % LANE
    r = F.pad(x, (0, pad)).reshape(K, -1, LANE)
    real = (torch.arange(m + pad, device=x.device) < m).reshape(-1, LANE)
    pos = r >= 0
    pv, nv = pos & real, ~pos & real
    sp = torch.where(pv, r, 0.0).sum(-1, keepdim=True) \
        / pv.sum(-1, keepdim=True).clamp_min(1)
    sn = torch.where(nv, -r, 0.0).sum(-1, keepdim=True) \
        / nv.sum(-1, keepdim=True).clamp_min(1)
    dec = torch.where(pos, sp, -sn).reshape(K, -1)[:, :m]
    return dec, x - dec


def ring_sum(flat: torch.Tensor) -> torch.Tensor:
    """Full-precision ring allreduce of ``flat`` [K, L]: the sum worker 0
    ends with, [L]."""
    K, L = flat.shape
    m = -(-L // K)
    c = F.pad(flat, (0, K * m - L)).reshape(K, K, m).clone()
    w = torch.arange(K, device=flat.device)
    for i in range(K - 1):
        recv = c[(w - 1) % K, (w - 1 - i) % K]
        c[w, (w - i - 1) % K] += recv
    # worker j - 1 owns the reduced chunk j; worker 0 copies each
    return c[(w - 1) % K, w].reshape(-1)[:L]


def ring_onebit(cin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-bit ring allreduce of the compensated ``cin`` [K, P] (P a multiple
    of K; overwritten): (the decoded sum every worker ends with [P], each
    worker's accumulated quantization error [K, P])."""
    K, P = cin.shape
    m = P // K
    c = cin.reshape(K, K, m)
    res = torch.zeros_like(c)
    w = torch.arange(K, device=cin.device)
    for i in range(K - 1):
        sent = (w - i - 1) % K
        dec, err = _onebit(c[w, sent])
        res[w, sent] += err
        c[w, (w - i - 2) % K] += dec[(w - 1) % K]
    dec, err = _onebit(c[w, w])                 # each owner's reduced chunk
    res[w, w] += err
    return dec.reshape(-1), res.reshape(K, P)


def exchange(grads: List[Dict[str, torch.Tensor]], ef, leaves, buckets,
             method: str) -> Dict[str, torch.Tensor]:
    """The mean gradient every worker applies, by weight name, from the
    workers' gradients ``grads`` (consumed).  ``ef``: the workers'
    residuals per bucket index, [K, padded bucket length] (``onebit``;
    renewed in place, zeros when a bucket has none yet)."""
    K = len(grads)
    mean: Dict[str, torch.Tensor] = {}
    for bi, b in enumerate(buckets):
        shapes = [tuple(grads[0][leaves[i][0]].shape) for i in b]
        sizes = [len(leaves[i]) * grads[0][leaves[i][0]].numel() for i in b]
        L = sum(sizes)
        P = K * -(-L // K)
        flat = torch.zeros((K, P), dtype=torch.float32,
                           device=grads[0][leaves[b[0]][0]].device)
        for k in range(K):
            off = 0
            for i, n in zip(b, sizes):
                per = n // len(leaves[i])
                for name in leaves[i]:
                    flat[k, off:off + per] = grads[k].pop(name).reshape(-1)
                    off += per
        if method == "none":
            red = ring_sum(flat[:, :L])
        else:
            e = ef.get(bi)
            if e is None:
                e = torch.zeros_like(flat)
            cin = flat + EF_GAIN * e
            base = flat.add_(e).sub_(cin)            # (g + e) - c
            del e
            ef[bi] = None
            red, res = ring_onebit(cin)
            del cin
            ef[bi] = base.add_(res)
            del res, base
        del flat
        red = red[:L] / K
        off = 0
        for i, shape, n in zip(b, shapes, sizes):
            part = red[off:off + n].reshape((len(leaves[i]),) + shape)
            for j, name in enumerate(leaves[i]):
                mean[name] = part[j].clone()
            off += n
    return mean
