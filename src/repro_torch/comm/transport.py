"""Topology schedules over the port's worker axis (survey §3.3.1(2)):
the exact schedules, the codec schedules that carry encoded payloads,
and their byte models (the JAX package's ``comm/transport.py``).

The JAX module runs these as ``lax.ppermute`` schedules inside
``shard_map``; here a schedule takes ``x`` [n, ...] (row ``w`` is worker
``w``'s tensor) and returns every worker's result in the same layout,
through the ``core.collectives`` index operations.  Each hop and each
addition is the reference's, in the reference's order, so every worker's
sum is rounded as on the reference.

1. The **exact** schedules: full-precision; every worker ends with the
   same sum.  Per-device bytes of an n-worker reduce of size S:
     ring            2 (n-1)/n S        (bandwidth-optimal)
     butterfly       log2(n) S          (recursive doubling)
     tree            2 log2(n) S        (reduce to root + broadcast)
     fully-connected (n-1) S            (every worker sends its tensor)

2. The **codec** schedules (``compressed_allreduce`` /
   ``compressed_reduce_scatter``): the same topologies, but every
   transmission is encode -> permute the planes -> decode:
   * ring reduce-scatter: each hop encodes the partial sum it forwards;
     the hop's quantization error is added to the sender's EF residual at
     that chunk (per-link EF).
   * ring all-gather: each chunk's owner encodes it once (owner EF) and
     the planes are relayed unchanged, so every worker decodes identical
     bytes.
   * tree: re-encode up the reduce tree (sender EF per hop); the root
     encodes the total once and the planes broadcast down unchanged.
   * butterfly: lossy butterfly runs halving-doubling (recursive-halving
     reduce-scatter with hop EF + an all-gather of owner-encoded planes);
     a lossy recursive doubling would leave the replicas inconsistent.
   * fully-connected: every worker encodes its own contribution once and
     all-gathers the planes.
   Every generator returns ``(result [n, P], residual [n, P], sent [n])``:
   each worker's result, the EF contribution of every encode the worker
   made, and its count of data-dependent sparse elements shipped (dgc; 0
   otherwise).  The per-worker index arithmetic of the reference
   (``c.at[(me - i - 2) % n]``, ``lax.dynamic_slice`` at a per-worker
   start) is Python integer arithmetic over the rows here, with the same
   hop order; the stochastic codecs draw from one ``torch.Generator`` per
   exchange.

3. Byte models: ``schedule_tx_bytes`` is the mean per-worker bytes a
   schedule puts on the wire (total transmissions / n) for the
   shape-static part of the payloads; ``model_error_factor`` is the exact
   ratio between the critical-path model ``per_device_bytes`` and it.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.comm.codecs import NoneCodec, Planes, SegmentCodec
from repro_torch.core.collectives import (all_gather, axis_index, axis_size,
                                          ppermute, psum)


def _per_worker(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-worker bool [n] shaped to broadcast against ``x`` [n, ...]."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def ring_allreduce(x):
    """Bandwidth-optimal ring: reduce-scatter then all-gather, 2(n-1) steps."""
    n = axis_size(x)
    if n == 1:
        return x
    me = axis_index(x)
    flat = x.reshape(n, -1)
    L = flat.shape[1]
    m = -(-L // n)
    chunks = x.new_zeros((n, n * m))
    chunks[:, :L] = flat
    chunks = chunks.reshape(n, n, m)             # [worker, chunk, m]
    fwd = [(i, (i + 1) % n) for i in range(n)]
    for i in range(n - 1):
        recv = ppermute(chunks[me, (me - i) % n], fwd)
        dst = (me - i - 1) % n
        chunks[me, dst] = chunks[me, dst] + recv
    # rank r now owns reduced chunk (r + 1) % n
    for i in range(n - 1):
        recv = ppermute(chunks[me, (me + 1 - i) % n], fwd)
        chunks[me, (me - i) % n] = recv
    return chunks.reshape(n, -1)[:, :L].reshape(x.shape)


def butterfly_allreduce(x):
    """Recursive doubling: log2(n) exchange-and-add rounds (n power of 2)."""
    n = axis_size(x)
    if n == 1:
        return x
    if n & (n - 1):
        raise ValueError("butterfly requires power-of-two workers")
    acc = x
    for k in range(int(math.log2(n))):
        d = 1 << k
        acc = acc + ppermute(acc, [(i, i ^ d) for i in range(n)])
    return acc


def tree_allreduce(x):
    """Binomial tree: reduce to rank 0, then broadcast back down."""
    n = axis_size(x)
    if n == 1:
        return x
    levels = int(math.log2(n))
    if 1 << levels != n:
        raise ValueError("tree requires power-of-two workers")
    me = axis_index(x)
    acc = x
    # reduce phase: at level k, ranks with me % 2^(k+1) == 2^k send down
    for k in range(levels):
        d = 1 << k
        recv = ppermute(acc, [(i, i - d) for i in range(n)
                              if i % (2 * d) == d])
        acc = torch.where(_per_worker(me % (2 * d) == 0, x), acc + recv, acc)
    # broadcast phase
    for k in reversed(range(levels)):
        d = 1 << k
        recv = ppermute(acc, [(i, i + d) for i in range(n)
                              if i % (2 * d) == 0])
        acc = torch.where(_per_worker(me % (2 * d) == d, x), recv, acc)
    return acc


def fully_connected_allreduce(x):
    """Every worker sends its full tensor to every other (the O(n^2)
    traffic case the survey warns about); numerically an all_gather + sum,
    the same rows summed in the same order on every worker."""
    total = all_gather(x)[0].sum(0).to(x.dtype)
    return total[None].expand_as(x)


def psum_allreduce(x):
    return psum(x)


SCHEDULES = {
    "ring": ring_allreduce,
    "butterfly": butterfly_allreduce,
    "tree": tree_allreduce,
    "fully_connected": fully_connected_allreduce,
    "psum": psum_allreduce,
}


def pad_for_schedule(length: int, n: int) -> int:
    """Padded flat length for a chunked schedule: a whole number of 1/n
    chunks (codecs row-pad each payload internally)."""
    return n * (-(-length // n))


# ===================================================== codec schedules
Exchange = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _permute(planes: Planes, perm) -> Planes:
    return {k: ppermute(p, perm) for k, p in planes.items()}


def _where_planes(cond: torch.Tensor, new: Planes, old: Planes) -> Planes:
    return {k: torch.where(_per_worker(cond, new[k]), new[k], old[k])
            for k in new}


def _rows(idx, x: torch.Tensor) -> torch.Tensor:
    """Row ``idx[w]`` of worker w's block of ``x`` [n, k, m]: [n, m]."""
    return torch.stack([x[w, j] for w, j in enumerate(idx)])


def _ring_rs(flat, codec: SegmentCodec, gen, n: int):
    """Compressed ring reduce-scatter over ``flat`` [n, P]: worker r ends
    owning reduced chunk r.  Returns (chunks [n, n, m] with chunk r of
    worker r reduced, residual [n, n, m], sent [n])."""
    c = flat.reshape(n, n, -1)
    res = torch.zeros_like(c)
    sent = torch.zeros(n, dtype=torch.int64, device=flat.device)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    m = c.shape[2]
    for i in range(n - 1):
        pos = [(w - i - 1) % n for w in range(n)]
        # fused encode + hop EF: the planes and the quantization residual
        # (send - decode) from one read of the chunk
        planes, r = codec.encode_ef(_rows(pos, c), gen)
        for w, j in enumerate(pos):
            res[w, j] += r[w]
        del r
        sent += codec.sent_elems(planes)
        recv = codec.decode(_permute(planes, fwd))[:, :m]
        del planes
        for w in range(n):
            c[w, (w - i - 2) % n] += recv[w]
        del recv
    return c, res, sent


def _owner_encode(c, res, codec: SegmentCodec, gen):
    """Encode worker w's chunk w once at its owner (EF the encode error)
    and replace it with its own decode, so every worker, the owner
    included, consumes identical bytes.  Returns the planes; encoding is
    not a transmission (the caller counts each send)."""
    n, _, m = c.shape
    own = list(range(n))
    chunk = _rows(own, c)
    planes = codec.encode(chunk, gen)
    dec = codec.decode(planes)[:, :m]
    for w in own:
        res[w, w] += chunk[w] - dec[w]
        c[w, w] = dec[w]
    return planes


def _ring_exchange(flat, codec: SegmentCodec, gen) -> Exchange:
    n = axis_size(flat)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    c, res, sent = _ring_rs(flat, codec, gen, n)
    m = c.shape[2]
    planes = _owner_encode(c, res, codec, gen)
    for i in range(n - 1):
        # one transmission per hop: i = 0 is the owner's own send, later
        # ones relay it, n - 1 sends per plane
        sent += codec.sent_elems(planes)
        planes = _permute(planes, fwd)
        dec = codec.decode(planes)[:, :m]
        for w in range(n):
            c[w, (w - 1 - i) % n] = dec[w]
        del dec
    return c.reshape(n, -1), res.reshape(n, -1), sent


def _butterfly_exchange(flat, codec: SegmentCodec, gen) -> Exchange:
    """Halving-doubling: recursive-halving RS (hop EF) + an all-gather of
    the owner-encoded chunk planes (consistent decode everywhere)."""
    n = axis_size(flat)
    if n & (n - 1):
        raise ValueError("butterfly requires power-of-two workers")
    acc = flat.reshape(n, n, -1)
    m = acc.shape[2]
    res = torch.zeros_like(acc)
    sent = torch.zeros(n, dtype=torch.int64, device=flat.device)
    for k in range(int(math.log2(n))):
        d = n >> (k + 1)                      # rank and chunk distance
        base = [w & ~((n >> k) - 1) for w in range(n)]
        mine = [b + (d if w & d else 0) for w, b in enumerate(base)]
        other = [b + (0 if w & d else d) for w, b in enumerate(base)]
        send = torch.stack([acc[w, s:s + d].reshape(-1)
                            for w, s in enumerate(other)])
        planes, r = codec.encode_ef(send, gen)
        del send
        for w, s in enumerate(other):
            res[w, s:s + d] += r[w].reshape(d, m)
        del r
        sent += codec.sent_elems(planes)
        recv = codec.decode(_permute(planes, [(i, i ^ d) for i in range(n)]))
        del planes
        for w, s in enumerate(mine):
            acc[w, s:s + d] += recv[w, :d * m].reshape(d, m)
        del recv
    planes = _owner_encode(acc, res, codec, gen)
    sent += codec.sent_elems(planes) * (n - 1)        # AG transmissions
    # every worker gathers all n owners' planes and decodes the same chunks
    chunks = codec.decode(planes)[:, :m]
    out = chunks.reshape(1, -1).expand(n, -1)
    return out, res.reshape(n, -1), sent


def _tree_exchange(flat, codec: SegmentCodec, gen) -> Exchange:
    n = axis_size(flat)
    levels = int(math.log2(n))
    if 1 << levels != n:
        raise ValueError("tree requires power-of-two workers")
    me = axis_index(flat)
    L = flat.shape[1]
    acc = flat
    res = torch.zeros_like(flat)
    sent = torch.zeros(n, dtype=torch.int64, device=flat.device)
    # reduce: senders re-encode their partial and EF the encode error
    for k in range(levels):
        d = 1 << k
        is_sender = me % (2 * d) == d
        is_receiver = me % (2 * d) == 0
        planes, r = codec.encode_ef(acc, gen)
        res = res + torch.where(is_sender[:, None], r, 0.0)
        sent += torch.where(is_sender, codec.sent_elems(planes), 0)
        perm = [(i, i - d) for i in range(n) if i % (2 * d) == d]
        recv = codec.decode(_permute(planes, perm))[:, :L]
        acc = torch.where(is_receiver[:, None], acc + recv, acc)
    # the root encodes the total once; the planes broadcast down
    # unchanged (each of the n - 1 forwards is counted below)
    planes, r = codec.encode_ef(acc, gen)
    res = res + torch.where((me == 0)[:, None], r, 0.0)
    for k in reversed(range(levels)):
        d = 1 << k
        is_sender = me % (2 * d) == 0
        is_receiver = me % (2 * d) == d
        sent += torch.where(is_sender, codec.sent_elems(planes), 0)
        perm = [(i, i + d) for i in range(n) if i % (2 * d) == 0]
        planes = _where_planes(is_receiver, _permute(planes, perm), planes)
    return codec.decode(planes)[:, :L], res, sent


def _fully_connected_exchange(flat, codec: SegmentCodec, gen) -> Exchange:
    n, L = flat.shape
    planes, res = codec.encode_ef(flat, gen)
    sent = codec.sent_elems(planes) * (n - 1)
    # every worker gathers the n payloads and sums their decodes in worker
    # order: the same total everywhere
    total = codec.decode(planes)[:, :L].sum(0)
    return total[None].expand(n, -1), res, sent


_CODEC_EXCHANGES = {
    "ring": _ring_exchange,
    "psum": _ring_exchange,        # psum ring-schedules on the torus
    "butterfly": _butterfly_exchange,
    "tree": _tree_exchange,
    "fully_connected": _fully_connected_exchange,
}


def compressed_allreduce(flat, topology: str, codec: SegmentCodec,
                         gen=None) -> Exchange:
    """Sum-allreduce ``flat`` [n, P] (P from ``pad_for_schedule``) with
    encoded payloads inside the ``topology`` schedule.  Returns
    ``(reduced_sum [n, P], ef_residual [n, P], sent_elems [n])``; callers
    divide by n for the mean and fold the residual into each worker's
    error feedback.  ``flat`` is worked on in place."""
    return _CODEC_EXCHANGES[topology](flat, codec, gen)


def compressed_reduce_scatter(flat, codec: SegmentCodec,
                              gen=None) -> Exchange:
    """Compressed ring reduce-scatter: worker r receives reduced chunk r
    of ``flat`` [n, P] ([n, P / n]).  Returns (shards, residual [n, P],
    sent [n]), the gradient-push half of the PS / ZeRO exchange."""
    n = axis_size(flat)
    c, res, sent = _ring_rs(flat, codec, gen, n)
    return _rows(range(n), c), res.reshape(n, -1), sent


def _compensate(flat, ef, gain):
    """``(c_in, (flat + ef) - c_in)``: the over-relaxed input and the part
    of the next residual that does not come from the hops, the second in
    ``flat``'s buffer."""
    cin = flat + gain * ef
    return cin, flat.add_(ef).sub_(cin)


def compressed_allreduce_ef(flat, ef, topology: str, codec: SegmentCodec,
                            gen=None, *, gain: float = 1.0) -> Exchange:
    """EF-compensated exchange: compensate ``c_in = flat + gain * ef``,
    run the codec schedule (every hop's encode is the fused
    ``encode_ef``), and fold the hop residuals into the next residual,
    measured against the true compensated gradient ``flat + ef``, so the
    telescoping invariant holds for any gain.  Returns
    ``(reduced_sum, new_ef, sent_elems)``.  ``flat``'s buffer becomes
    ``new_ef``."""
    cin, new_ef = _compensate(flat, ef, gain)
    red, res, sent = _CODEC_EXCHANGES[topology](cin, codec, gen)
    return red, new_ef.add_(res), sent


def compressed_reduce_scatter_ef(flat, ef, codec: SegmentCodec, gen=None, *,
                                 gain: float = 1.0) -> Exchange:
    """EF-compensated ring reduce-scatter (``compressed_allreduce_ef``'s
    PS / ZeRO gradient-push counterpart)."""
    cin, new_ef = _compensate(flat, ef, gain)
    shard, res, sent = compressed_reduce_scatter(cin, codec, gen)
    return shard, new_ef.add_(res), sent


# ======================================================== byte models
def per_device_bytes(topology: str, n: int, size_bytes: float) -> float:
    """Analytic critical-path traffic for one exchange: the bytes crossing
    the busiest device's links.  ``model_error_factor`` relates it to the
    measured mean per-worker tx bytes."""
    if n == 1:
        return 0.0
    if topology in ("ring", "psum"):
        return 2 * (n - 1) / n * size_bytes
    if topology == "butterfly":
        return math.log2(n) * size_bytes
    if topology == "tree":
        return 2 * math.log2(n) * size_bytes
    if topology == "fully_connected":
        return (n - 1) * size_bytes
    raise ValueError(topology)


def schedule_tx_bytes(topology: str, n: int, length: int,
                      codec: SegmentCodec) -> float:
    """Mean per-worker bytes one exchange of a padded length-``length``
    segment puts on the wire (total transmissions / n), shape-static part
    of the codec's payloads; dgc adds 8 B per ``sent_elems``."""
    if n == 1:
        return 0.0
    m = -(-length // n)
    e = codec.static_tx_bytes
    if topology in ("ring", "psum"):
        # RS: n-1 hop encodes; AG: owner encode relayed n-1 hops
        return (n - 1) * e(m) + (n - 1) * e(m)
    if topology == "butterfly":
        if codec.exact:
            return math.log2(n) * e(length)       # recursive doubling
        rs = sum(e((n >> (k + 1)) * m) for k in range(int(math.log2(n))))
        return rs + (n - 1) * e(m)                # halving + plane AG
    if topology == "tree":
        # n-1 reduce sends + n-1 broadcast forwards of the full payload
        return 2 * (n - 1) / n * e(length)
    if topology == "fully_connected":
        return (n - 1) * e(length)
    raise ValueError(topology)


def fp32_schedule_bytes(topology: str, n: int, length: int) -> float:
    """Mean per-worker tx bytes of the full-precision schedule: the
    baseline compressed-payload ratios are quoted against."""
    return schedule_tx_bytes(topology, n, length, NoneCodec())


def model_error_factor(topology: str, n: int, exact: bool = True) -> float:
    """The ratio ``per_device_bytes / schedule_tx_bytes`` per topology:
    the critical-path model counts the busiest device (tree: the root's
    rx + tx), the measured accounting the mean per-worker tx."""
    if n == 1:
        return 1.0
    if topology in ("ring", "psum", "fully_connected"):
        return 1.0
    if topology == "tree":
        return math.log2(n) * n / (n - 1)
    if topology == "butterfly":
        if exact:
            return 1.0
        return math.log2(n) * n / (2 * (n - 1))
    raise ValueError(topology)
