"""Segment codecs: the on-the-wire encodings that travel *inside* the
collective schedules of ``comm.transport`` (the JAX package's
``comm/codecs.py``).

A codec maps a flat fp32 segment to a dict of fixed-shape tensors, the
*planes*, and back.  On the port's worker axis every call encodes all
workers' segments at once, worker ``w`` in row ``w``:

    planes = codec.encode(seg, gen)     # seg: [n, L] fp32, any L
    seg'   = codec.decode(planes)       # [n, rows * LANE]; schedules
                                        # slice to L

``encode_ef(seg, gen)`` is the fused form every lossy hop calls: the
planes and the sender's error-feedback residual ``seg - decode[:, :L]``
from one pass (on the kernel backend the segment is read once).

Planes are what the schedules permute, so the wire format is physical:
onebit signs packed 32 per 32-bit word (``kernels.onebit.pack_bits``),
terngrad digits 16 per word, both held as int32 with the JAX package's
uint32 bits.  Segments are padded to whole ``LANE``-wide rows; every
data-dependent statistic (dgc's quantile threshold, terngrad's clip and
scale, onebit's bin means) is taken per worker over the unpadded
elements, and every kernel launch covers all workers' rows with one
scalar per worker (``S = n`` segments).

The stochastic codecs (terngrad, qsgd) draw their uniform noise ``u``
[n, rows, LANE] from the ``torch.Generator`` they are given, or take it
as ``u=``: the JAX package splits a PRNG key per hop, which a generator
cannot reproduce, so the parity tests hand the reference's draws in.

``static_tx_bytes(L)`` is the byte count of one encoded length-``L``
segment over the unpadded payload (row side information is charged per
padded row); for dgc it covers the packed 1-bit remainder plane only, and
the value/index pairs of the sparse plane are counted per transmission
from ``sent_elems`` (8 B each), so the measured accounting follows the
threshold's payload from step to step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.compression import Compressor
from repro_torch.kernels import onebit as K1
from repro_torch.kernels import qsgd as KQ
from repro_torch.kernels import terngrad as KT
from repro_torch.kernels import topk as KK
from repro_torch.kernels.segments import per_segment
from repro_torch.kernels.terngrad.ref import std0

LANE = 256          # encode rows are [ceil(L / LANE), LANE]

Planes = Dict[str, torch.Tensor]


def _pad_rows(seg: torch.Tensor):
    """[n, L] -> ([n, R, LANE] rows, valid mask [R, LANE] or None, L)."""
    n, L = seg.shape
    pad = (-L) % LANE
    x = F.pad(seg.float(), (0, pad)).reshape(n, -1, LANE)
    valid = ((torch.arange(L + pad, device=seg.device) < L).reshape(-1, LANE)
             if pad else None)
    return x, valid, L


def _rows_of(length: int) -> int:
    return -(-length // LANE)


def _flat_rows(x: torch.Tensor) -> torch.Tensor:
    """[n, R, LANE] -> [n * R, LANE]: every worker's rows in one block."""
    return x.reshape(-1, LANE)


def _repeat_rows(mask: Optional[torch.Tensor], n: int):
    """A [R, LANE] mask repeated for n workers' rows, [n * R, LANE]."""
    return None if mask is None else mask.repeat(n, 1)


def _uniform(shape, like: torch.Tensor, gen, u):
    """The stochastic codecs' noise: ``u`` when given, else drawn."""
    if u is not None:
        return u.reshape(shape).float().to(like.device)
    return torch.rand(shape, generator=gen, device=like.device)


class SegmentCodec:
    """Stateless segment encoder/decoder.  ``exact`` codecs (``none``)
    round-trip bit for bit, so the transport runs the full-precision
    schedule for them."""

    name: str = "?"
    exact: bool = False
    lossy_ef: bool = False      # hop errors belong in an EF residual
    draws: bool = False         # encode draws uniform noise [n, rows, LANE]

    def __init__(self, backend: str = "auto"):
        self.backend = backend

    def encode(self, seg, gen=None, u=None) -> Planes:
        raise NotImplementedError

    def decode(self, planes: Planes) -> torch.Tensor:
        raise NotImplementedError

    def encode_ef(self, seg, gen=None, u=None) -> Tuple[Planes,
                                                         torch.Tensor]:
        """Encode + the sender's EF residual in one call:
        ``(planes, seg - decode(planes)[:, :L])``."""
        planes = self.encode(seg, gen, u)
        return planes, seg - self.decode(planes)[:, :seg.shape[1]]

    def static_tx_bytes(self, length: int) -> int:
        """Shape-static wire bytes of one encoded length-``length``
        segment (without dgc's data-dependent value/index pairs)."""
        raise NotImplementedError

    def sent_elems(self, planes: Planes) -> torch.Tensor:
        """Per-worker count [n] of data-dependent value/index pairs in
        ``planes`` (0 for every shape-static codec)."""
        first = next(iter(planes.values()))
        return torch.zeros(first.shape[0], dtype=torch.int64,
                           device=first.device)


class NoneCodec(SegmentCodec):
    name = "none"
    exact = True

    def encode(self, seg, gen=None, u=None):
        return {"x": seg}

    def decode(self, planes):
        return planes["x"]

    def static_tx_bytes(self, length: int) -> int:
        return 4 * length


class OnebitCodec(SegmentCodec):
    """1-bit signs (packed 32 per word) + per-row two-bin means."""
    name = "onebit"
    lossy_ef = True

    def _rows(self, seg):
        """(planes, residual rows [n, R, LANE], L): one fused encode+EF
        pass over every worker's rows."""
        c, valid, L = _pad_rows(seg)
        n, R, _ = c.shape
        signs, sp, sn, _, new_e = K1.encode_ef(
            _flat_rows(c), None, _repeat_rows(valid, n), backend=self.backend)
        planes = {"words": K1.pack_bits(signs).reshape(n, R, LANE // 32),
                  "sp": sp.reshape(n, R, 1), "sn": sn.reshape(n, R, 1)}
        return planes, new_e.reshape(n, R, LANE), L

    def encode(self, seg, gen=None, u=None):
        return self._rows(seg)[0]

    def encode_ef(self, seg, gen=None, u=None):
        planes, new_e, L = self._rows(seg)
        return planes, new_e.reshape(seg.shape[0], -1)[:, :L]

    def decode(self, planes):
        signs = K1.unpack_bits(planes["words"], LANE)
        out = torch.where(signs > 0, planes["sp"], -planes["sn"])
        return out.reshape(out.shape[0], -1)

    def static_tx_bytes(self, length: int) -> int:
        return -(-length // 8) + 8 * _rows_of(length)


class TerngradCodec(SegmentCodec):
    """Stochastic ternary digits packed 16 per 32-bit word + one scale
    per worker."""
    name = "terngrad"
    draws = True

    def __init__(self, clip_sigma: float = 2.5, backend: str = "auto"):
        super().__init__(backend)
        self.clip_sigma = clip_sigma

    def encode(self, seg, gen=None, u=None):
        g0 = seg.float()                  # statistics on unpadded data
        if self.clip_sigma:
            # each worker's sigma from its own row (``per_segment``), so a
            # process holding one worker gets the logical axis's bits
            sigma = per_segment(std0, g0)[:, None]
            g0 = torch.clamp(g0, -self.clip_sigma * sigma,
                             self.clip_sigma * sigma)
        lo, hi = torch.aminmax(g0, dim=1)
        s = torch.maximum(-lo, hi)                        # max|g0|, [n]
        c, _, _ = _pad_rows(g0)
        del g0
        n, R, _ = c.shape
        u = _uniform(c.shape, c, gen, u)
        tern = KT.ternarize(_flat_rows(c), _flat_rows(u), s,
                            backend=self.backend)
        del c, u
        # digit j (tern + 1, two bits) of word w is element 16 w + j
        digits = tern.reshape(n, R, LANE // 16, 16)
        words = torch.zeros(digits.shape[:-1], dtype=torch.int64,
                            device=digits.device)
        for j in range(16):
            words |= (digits[..., j] + 1).to(torch.int64) << (2 * j)
        words = (words - ((words >> 31) << 32)).to(torch.int32)
        return {"words": words, "s": s}

    def decode(self, planes):
        words = planes["words"]
        shifts = 2 * torch.arange(16, dtype=torch.int32, device=words.device)
        digits = (words[..., None] >> shifts) & 3
        tern = digits.float() - 1.0
        n = words.shape[0]
        return tern.reshape(n, -1) * planes["s"][:, None]

    def static_tx_bytes(self, length: int) -> int:
        return -(-length // 4) + 4


class QsgdCodec(SegmentCodec):
    """s-level stochastic quantization: int8 levels + one l2 norm per
    worker."""
    name = "qsgd"
    draws = True

    def __init__(self, s_levels: int = 127, backend: str = "auto"):
        super().__init__(backend)
        self.s_levels = s_levels

    def encode(self, seg, gen=None, u=None):
        g32, _, _ = _pad_rows(seg)        # pad zeros do not move the l2
        n = g32.shape[0]
        u = _uniform(g32.shape, g32, gen, u)
        q, norm = KQ.quantize(_flat_rows(g32), _flat_rows(u),
                              s_levels=self.s_levels, segments=n,
                              backend=self.backend)
        return {"q": q.reshape(g32.shape), "norm": norm.reshape(n)}

    def decode(self, planes):
        q = planes["q"]
        out = q.float() * (planes["norm"] / self.s_levels)[:, None, None]
        return out.reshape(q.shape[0], -1)

    def static_tx_bytes(self, length: int) -> int:
        return length + 4


class DgcCodec(SegmentCodec):
    """Threshold-sparse values + a 1-bit plane for the remainder.

    The values plane is dense fp32 (payloads are fixed-shape) but its
    *wire* size is the sparse accounting: 8 bytes per element above the
    worker's threshold, counted per transmission from ``sent_elems``.  The
    untransmitted remainder rides the same packed 1-bit plane as
    ``onebit``, masked out of the bin means."""
    name = "dgc"
    lossy_ef = True

    def __init__(self, density: float = 0.01, backend: str = "auto"):
        super().__init__(backend)
        self.density = density

    def _planes(self, seg):
        n = seg.shape[0]
        # each worker's quantile threshold over its unpadded payload
        th = KK.threshold_for_density(seg, None, self.density, segments=n)
        c, valid, L = _pad_rows(seg)
        R = c.shape[1]
        # the kernel keeps |c| >= th; an exact zero never ships (the wire
        # holds (index, value) pairs, and a degenerate threshold of 0 must
        # not count zeros as payload): kept != 0 is (|c| >= th) & (c != 0)
        kept, _ = KK.sparsify(_flat_rows(c), None, th, backend=self.backend)
        mask = kept.reshape(c.shape) != 0.0
        del kept
        if valid is not None:
            mask &= valid
        kept = torch.where(mask, c, 0.0)
        rem = c - kept
        del c
        unsent = ~mask if valid is None else (~mask & valid)
        signs, sp, sn, _, rem_e = K1.encode_ef(
            _flat_rows(rem), None, _flat_rows(unsent), backend=self.backend)
        planes = {"kept": kept, "mask": mask,
                  "words": K1.pack_bits(signs).reshape(n, R, LANE // 32),
                  "sp": sp.reshape(n, R, 1), "sn": sn.reshape(n, R, 1)}
        return planes, rem_e.reshape(n, -1), L

    def encode(self, seg, gen=None, u=None):
        return self._planes(seg)[0]

    def encode_ef(self, seg, gen=None, u=None):
        # residual = seg - decode = (c - kept) - rem_out = rem_e
        planes, rem_e, L = self._planes(seg)
        return planes, rem_e[:, :L]

    def decode(self, planes):
        signs = K1.unpack_bits(planes["words"], LANE)
        rem = torch.where(signs > 0, planes["sp"], -planes["sn"])
        rem = torch.where(planes["mask"], 0.0, rem)
        out = planes["kept"] + rem
        return out.reshape(out.shape[0], -1)

    def static_tx_bytes(self, length: int) -> int:
        # the packed remainder plane; kept values are counted per send
        return -(-length // 8) + 8 * _rows_of(length)

    def sent_elems(self, planes):
        return planes["mask"].reshape(planes["mask"].shape[0], -1).sum(1)


# 4 B value + 4 B index per data-dependent sparse element on the wire
SPARSE_ELEM_BYTES = 8


def make_codec(method: str, backend: str = "auto", **kw) -> SegmentCodec:
    if method == "none":
        return NoneCodec(backend)
    if method == "onebit":
        return OnebitCodec(backend)
    if method == "terngrad":
        return TerngradCodec(backend=backend, **kw)
    if method == "qsgd":
        return QsgdCodec(backend=backend, **kw)
    if method == "dgc":
        return DgcCodec(backend=backend, **kw)
    raise ValueError(f"no segment codec for method {method!r}")


def codec_for(compressor: Compressor) -> SegmentCodec:
    """The segment codec matching a ``Compressor`` (same method, same
    quantization knobs, same kernel backend; EF and reconstruction knobs
    live in the transport)."""
    m = compressor.method
    be = compressor.backend
    if m == "terngrad":
        return TerngradCodec(clip_sigma=compressor.clip_sigma, backend=be)
    if m == "qsgd":
        return QsgdCodec(s_levels=compressor.s_levels, backend=be)
    if m == "dgc":
        return DgcCodec(density=compressor.density, backend=be)
    return make_codec(m, backend=be)
