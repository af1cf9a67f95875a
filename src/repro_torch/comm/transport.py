"""Topology schedules over the port's worker axis (survey §3.3.1(2)):
the exact schedules, the codec schedules that carry encoded payloads,
and their byte models (the JAX package's ``comm/transport.py``).

The JAX module runs these as ``lax.ppermute`` schedules inside
``shard_map``; here a schedule takes ``x`` [k, ...] and an ``axis``
(``core.collectives``): row ``r`` is worker ``axis.ids[r]``'s tensor, and
the result comes back in the same layout.  The default axis is every row
as a logical worker (k = n, one process); a ``DistAxis`` holds one worker
per ``torch.distributed`` rank (k = 1).  Each hop and each addition is
the reference's, in the reference's order, so every worker's sum is
rounded as on the reference, on either axis.

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
   Every schedule returns ``(result [k, P], residual [k, P], sent [k])``:
   each worker's result, the EF contribution of every encode the worker
   made, and its count of data-dependent sparse elements shipped (dgc; 0
   otherwise).  The per-worker index arithmetic of the reference
   (``c.at[(me - i - 2) % n]``, ``lax.dynamic_slice`` at a per-worker
   start) is Python integer arithmetic over each held worker's id, with
   the same hop order; the stochastic codecs draw one [n, ...] block per
   encode from one ``torch.Generator`` per exchange, and a process that
   holds some of the workers draws the whole block and keeps its rows.

3. Byte models: ``schedule_tx_bytes`` is the mean per-worker bytes a
   schedule puts on the wire (total transmissions / n) for the
   shape-static part of the payloads; ``model_error_factor`` is the exact
   ratio between the critical-path model ``per_device_bytes`` and it.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.comm.codecs import LANE, NoneCodec, Planes, SegmentCodec
from repro_torch.core.collectives import Axis, axis_of as _axis


def _per_worker(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-worker bool [k] shaped to broadcast against ``x`` [k, ...]."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def ring_allreduce(x, axis=None):
    """Bandwidth-optimal ring: reduce-scatter then all-gather, 2(n-1) steps."""
    ax = _axis(x, axis)
    n = ax.size
    if n == 1:
        return x
    me = ax.index(x)
    k = x.shape[0]
    rows = torch.arange(k, device=x.device)
    flat = x.reshape(k, -1)
    L = flat.shape[1]
    m = -(-L // n)
    chunks = x.new_zeros((k, n * m))
    chunks[:, :L] = flat
    chunks = chunks.reshape(k, n, m)             # [row, chunk, m]
    fwd = [(i, (i + 1) % n) for i in range(n)]
    for i in range(n - 1):
        recv = ax.ppermute(chunks[rows, (me - i) % n], fwd)
        dst = (me - i - 1) % n
        chunks[rows, dst] = chunks[rows, dst] + recv
    # rank r now owns reduced chunk (r + 1) % n
    for i in range(n - 1):
        recv = ax.ppermute(chunks[rows, (me + 1 - i) % n], fwd)
        chunks[rows, (me - i) % n] = recv
    return chunks.reshape(k, -1)[:, :L].reshape(x.shape)


def butterfly_allreduce(x, axis=None):
    """Recursive doubling: log2(n) exchange-and-add rounds (n power of 2)."""
    ax = _axis(x, axis)
    n = ax.size
    if n == 1:
        return x
    if n & (n - 1):
        raise ValueError("butterfly requires power-of-two workers")
    acc = x
    for k in range(int(math.log2(n))):
        d = 1 << k
        acc = acc + ax.ppermute(acc, [(i, i ^ d) for i in range(n)])
    return acc


def tree_allreduce(x, axis=None):
    """Binomial tree: reduce to rank 0, then broadcast back down."""
    ax = _axis(x, axis)
    n = ax.size
    if n == 1:
        return x
    levels = int(math.log2(n))
    if 1 << levels != n:
        raise ValueError("tree requires power-of-two workers")
    me = ax.index(x)
    acc = x
    # reduce phase: at level k, ranks with me % 2^(k+1) == 2^k send down
    for k in range(levels):
        d = 1 << k
        recv = ax.ppermute(acc, [(i, i - d) for i in range(n)
                                 if i % (2 * d) == d])
        acc = torch.where(_per_worker(me % (2 * d) == 0, x), acc + recv, acc)
    # broadcast phase
    for k in reversed(range(levels)):
        d = 1 << k
        recv = ax.ppermute(acc, [(i, i + d) for i in range(n)
                                 if i % (2 * d) == 0])
        acc = torch.where(_per_worker(me % (2 * d) == d, x), recv, acc)
    return acc


def fully_connected_allreduce(x, axis=None):
    """Every worker sends its full tensor to every other (the O(n^2)
    traffic case the survey warns about); numerically an all_gather + sum,
    the same rows summed in the same order on every worker."""
    total = _axis(x, axis).all_gather(x)[0].sum(0).to(x.dtype)
    return total[None].expand_as(x)


def psum_allreduce(x, axis=None):
    return _axis(x, axis).psum(x)


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


def _where_planes(cond: torch.Tensor, new: Planes, old: Planes) -> Planes:
    return {k: torch.where(_per_worker(cond, new[k]), new[k], old[k])
            for k in new}


def _rows(idx, x: torch.Tensor) -> torch.Tensor:
    """Row ``idx[r]`` of row r's block of ``x`` [k, n, m]: [k, m]."""
    return torch.stack([x[r, j] for r, j in enumerate(idx)])


def _noise(codec: SegmentCodec, seg: torch.Tensor, gen, ax: Axis):
    """The stochastic codecs' uniform draws for ``seg`` [k, L] when this
    process holds only some of the workers: the whole axis's [n, rows,
    LANE] block from ``gen``, then this process's rows, so that each
    worker's noise is the logical axis's.  None where the codec draws
    nothing or holds every worker (it then draws the block itself)."""
    if not codec.draws or ax.holds_all:
        return None
    shape = (ax.size, -(-seg.shape[1] // LANE), LANE)
    return torch.rand(shape, generator=gen, device=seg.device)[ax.ids]


def _encode(codec: SegmentCodec, seg, gen, ax: Axis) -> Planes:
    return codec.encode(seg, gen, _noise(codec, seg, gen, ax))


def _encode_ef(codec: SegmentCodec, seg, gen, ax: Axis):
    return codec.encode_ef(seg, gen, _noise(codec, seg, gen, ax))


def _gathered(planes: Planes, ax: Axis) -> Planes:
    """Every worker's planes, [n, ...] in worker order (each process
    holding all of them after an all-gather)."""
    if ax.holds_all:
        return planes
    return {key: p[0] for key, p in ax.all_gather(planes).items()}


def _ring_rs(flat, codec: SegmentCodec, gen, ax: Axis):
    """Compressed ring reduce-scatter over ``flat`` [k, P]: worker w ends
    owning reduced chunk w.  Returns (chunks [k, n, m] with chunk w of
    worker w reduced, residual [k, n, m], sent [k])."""
    n = ax.size
    c = flat.reshape(flat.shape[0], n, -1)
    res = torch.zeros_like(c)
    sent = torch.zeros(c.shape[0], dtype=torch.int64, device=flat.device)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    m = c.shape[2]
    for i in range(n - 1):
        pos = [(w - i - 1) % n for w in ax.ids]
        # fused encode + hop EF: the planes and the quantization residual
        # (send - decode) from one read of the chunk
        planes, r = _encode_ef(codec, _rows(pos, c), gen, ax)
        for row, j in enumerate(pos):
            res[row, j] += r[row]
        del r
        sent += codec.sent_elems(planes)
        recv = codec.decode(ax.ppermute(planes, fwd))[:, :m]
        del planes
        for row, w in enumerate(ax.ids):
            c[row, (w - i - 2) % n] += recv[row]
        del recv
    return c, res, sent


def _owner_encode(c, res, codec: SegmentCodec, gen, ax: Axis):
    """Encode worker w's chunk w once at its owner (EF the encode error)
    and replace it with its own decode, so every worker, the owner
    included, consumes identical bytes.  Returns the planes; encoding is
    not a transmission (the caller counts each send)."""
    m = c.shape[2]
    chunk = _rows(ax.ids, c)
    planes = _encode(codec, chunk, gen, ax)
    dec = codec.decode(planes)[:, :m]
    for row, w in enumerate(ax.ids):
        res[row, w] += chunk[row] - dec[row]
        c[row, w] = dec[row]
    return planes


def _ring_exchange(flat, codec: SegmentCodec, gen, ax: Axis) -> Exchange:
    n = ax.size
    k = flat.shape[0]
    fwd = [(i, (i + 1) % n) for i in range(n)]
    c, res, sent = _ring_rs(flat, codec, gen, ax)
    m = c.shape[2]
    planes = _owner_encode(c, res, codec, gen, ax)
    for i in range(n - 1):
        # one transmission per hop: i = 0 is the owner's own send, later
        # ones relay it, n - 1 sends per plane
        sent += codec.sent_elems(planes)
        planes = ax.ppermute(planes, fwd)
        dec = codec.decode(planes)[:, :m]
        for row, w in enumerate(ax.ids):
            c[row, (w - 1 - i) % n] = dec[row]
        del dec
    return c.reshape(k, -1), res.reshape(k, -1), sent


def _butterfly_exchange(flat, codec: SegmentCodec, gen,
                        ax: Axis) -> Exchange:
    """Halving-doubling: recursive-halving RS (hop EF) + an all-gather of
    the owner-encoded chunk planes (consistent decode everywhere)."""
    n = ax.size
    if n & (n - 1):
        raise ValueError("butterfly requires power-of-two workers")
    k = flat.shape[0]
    acc = flat.reshape(k, n, -1)
    m = acc.shape[2]
    res = torch.zeros_like(acc)
    sent = torch.zeros(k, dtype=torch.int64, device=flat.device)
    for lvl in range(int(math.log2(n))):
        d = n >> (lvl + 1)                    # rank and chunk distance
        base = [w & ~((n >> lvl) - 1) for w in ax.ids]
        mine = [b + (d if w & d else 0) for w, b in zip(ax.ids, base)]
        other = [b + (0 if w & d else d) for w, b in zip(ax.ids, base)]
        send = torch.stack([acc[row, s:s + d].reshape(-1)
                            for row, s in enumerate(other)])
        planes, r = _encode_ef(codec, send, gen, ax)
        del send
        for row, s in enumerate(other):
            res[row, s:s + d] += r[row].reshape(d, m)
        del r
        sent += codec.sent_elems(planes)
        recv = codec.decode(ax.ppermute(planes,
                                        [(i, i ^ d) for i in range(n)]))
        del planes
        for row, s in enumerate(mine):
            acc[row, s:s + d] += recv[row, :d * m].reshape(d, m)
        del recv
    planes = _owner_encode(acc, res, codec, gen, ax)
    sent += codec.sent_elems(planes) * (n - 1)        # AG transmissions
    # every worker gathers all n owners' planes and decodes the same chunks
    chunks = codec.decode(_gathered(planes, ax))[:, :m]
    out = chunks.reshape(1, -1).expand(k, -1)
    return out, res.reshape(k, -1), sent


def _tree_exchange(flat, codec: SegmentCodec, gen, ax: Axis) -> Exchange:
    n = ax.size
    levels = int(math.log2(n))
    if 1 << levels != n:
        raise ValueError("tree requires power-of-two workers")
    me = ax.index(flat)
    L = flat.shape[1]
    acc = flat
    res = torch.zeros_like(flat)
    sent = torch.zeros(flat.shape[0], dtype=torch.int64, device=flat.device)
    # reduce: senders re-encode their partial and EF the encode error
    for lvl in range(levels):
        d = 1 << lvl
        is_sender = me % (2 * d) == d
        is_receiver = me % (2 * d) == 0
        planes, r = _encode_ef(codec, acc, gen, ax)
        res = res + torch.where(is_sender[:, None], r, 0.0)
        sent += torch.where(is_sender, codec.sent_elems(planes), 0)
        perm = [(i, i - d) for i in range(n) if i % (2 * d) == d]
        recv = codec.decode(ax.ppermute(planes, perm))[:, :L]
        acc = torch.where(is_receiver[:, None], acc + recv, acc)
    # the root encodes the total once; the planes broadcast down
    # unchanged (each of the n - 1 forwards is counted below)
    planes, r = _encode_ef(codec, acc, gen, ax)
    res = res + torch.where((me == 0)[:, None], r, 0.0)
    for lvl in reversed(range(levels)):
        d = 1 << lvl
        is_sender = me % (2 * d) == 0
        is_receiver = me % (2 * d) == d
        sent += torch.where(is_sender, codec.sent_elems(planes), 0)
        perm = [(i, i + d) for i in range(n) if i % (2 * d) == 0]
        planes = _where_planes(is_receiver, ax.ppermute(planes, perm),
                               planes)
    return codec.decode(planes)[:, :L], res, sent


def _fully_connected_exchange(flat, codec: SegmentCodec, gen,
                              ax: Axis) -> Exchange:
    k, L = flat.shape
    planes, res = _encode_ef(codec, flat, gen, ax)
    sent = codec.sent_elems(planes) * (ax.size - 1)
    # every worker gathers the n payloads and sums their decodes in worker
    # order: the same total everywhere
    total = codec.decode(_gathered(planes, ax))[:, :L].sum(0)
    return total[None].expand(k, -1), res, sent


_CODEC_EXCHANGES = {
    "ring": _ring_exchange,
    "psum": _ring_exchange,        # psum ring-schedules on the torus
    "butterfly": _butterfly_exchange,
    "tree": _tree_exchange,
    "fully_connected": _fully_connected_exchange,
}


def compressed_allreduce(flat, topology: str, codec: SegmentCodec,
                         gen=None, *, axis=None) -> Exchange:
    """Sum-allreduce ``flat`` [k, P] (P from ``pad_for_schedule``; a row
    per worker of ``axis`` this process holds, all of them by default)
    with encoded payloads inside the ``topology`` schedule.  Returns
    ``(reduced_sum [k, P], ef_residual [k, P], sent_elems [k])``; callers
    divide by n for the mean and fold the residual into each worker's
    error feedback.  ``flat`` is worked on in place."""
    return _CODEC_EXCHANGES[topology](flat, codec, gen, _axis(flat, axis))


def compressed_reduce_scatter(flat, codec: SegmentCodec,
                              gen=None, *, axis=None) -> Exchange:
    """Compressed ring reduce-scatter: worker w receives reduced chunk w
    of ``flat`` [k, P] ([k, P / n]).  Returns (shards, residual [k, P],
    sent [k]), the gradient-push half of the PS / ZeRO exchange."""
    ax = _axis(flat, axis)
    c, res, sent = _ring_rs(flat, codec, gen, ax)
    return _rows(ax.ids, c), res.reshape(flat.shape[0], -1), sent


def _compensate(flat, ef, gain):
    """``(c_in, (flat + ef) - c_in)``: the over-relaxed input and the part
    of the next residual that does not come from the hops, the second in
    ``flat``'s buffer."""
    cin = flat + gain * ef
    return cin, flat.add_(ef).sub_(cin)


def compressed_allreduce_ef(flat, ef, topology: str, codec: SegmentCodec,
                            gen=None, *, gain: float = 1.0,
                            axis=None) -> Exchange:
    """EF-compensated exchange: compensate ``c_in = flat + gain * ef``,
    run the codec schedule (every hop's encode is the fused
    ``encode_ef``), and fold the hop residuals into the next residual,
    measured against the true compensated gradient ``flat + ef``, so the
    telescoping invariant holds for any gain.  Returns
    ``(reduced_sum, new_ef, sent_elems)``.  ``flat``'s buffer becomes
    ``new_ef``."""
    cin, new_ef = _compensate(flat, ef, gain)
    red, res, sent = compressed_allreduce(cin, topology, codec, gen,
                                          axis=axis)
    return red, new_ef.add_(res), sent


def compressed_reduce_scatter_ef(flat, ef, codec: SegmentCodec, gen=None, *,
                                 gain: float = 1.0, axis=None) -> Exchange:
    """EF-compensated ring reduce-scatter (``compressed_allreduce_ef``'s
    PS / ZeRO gradient-push counterpart)."""
    cin, new_ef = _compensate(flat, ef, gain)
    shard, res, sent = compressed_reduce_scatter(cin, codec, gen, axis=axis)
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
