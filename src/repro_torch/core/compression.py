"""Gradient compression from survey §3.3.3 behind one leaf-list interface
with error-feedback state (the JAX package's ``core/compression.py``).

Methods (each backed by a hand-written CUDA kernel in
``repro_torch.kernels``, chosen through the ``backend`` seam: the kernel
for CUDA tensors, the plain version for CPU tensors):

  none      : fp32 gradients as-is (the survey's baseline)
  onebit    : 1-bit SGD + error feedback        [Seide et al., 159]
  terngrad  : stochastic ternary                [Wen et al., 190]
  qsgd      : s-level stochastic quantization   [Alistarh et al., 8]
  dgc       : threshold sparsify + error accum  [Lin et al., 106]

The math is the reference's (its module docstring explains it): two-bin
Seide reconstruction per row, rows along the tensor's trailing channel
axis when it has at least ``min_channel`` elements (else the flat
256-lane layout with the symmetric ``sign * mean|c|`` plane), and the EF
over-relaxation ``c_in = g + ef_gain * e`` with the residual measured
against ``g + e``; dgc's threshold is the quantile of the unpadded
compensated gradient and its untransmitted remainder travels as a 1-bit
plane.  Each onebit leaf is one call of the fused encode+EF entry
``kernels.onebit.encode_ef``.  terngrad and qsgd draw their uniform noise
from the ``torch.Generator`` the caller passes (the JAX package splits a
PRNG key per leaf; the two streams differ, so the parity tests hand the
reference's draws to ``_leaf``).

Gradients travel as a list of leaves in the reference's
``jax.tree.leaves`` order (``core.tree.LeafLayout``), not as a tree.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import onebit as K1
from repro_torch.kernels import qsgd as KQ
from repro_torch.kernels import terngrad as KT
from repro_torch.kernels import topk as KK
from repro_torch.kernels.backend import resolve_backend

_LANE = 256
# Default minimum trailing-axis length for per-channel two-bin
# reconstruction (the ``Compressor.min_channel`` field): with shorter
# channels the 8 B/row of bin means would rival the 1-bit plane itself.
_MIN_CHANNEL = 64

METHODS = ("none", "onebit", "terngrad", "qsgd", "dgc")
# methods that carry per-worker error-feedback state through the step
EF_METHODS = ("onebit", "dgc")


def _to2d(x):
    flat = x.reshape(-1)
    n = flat.shape[0]
    return F.pad(flat, (0, (-n) % _LANE)).reshape(-1, _LANE), n


def _from2d(x2d, n, shape):
    return x2d.reshape(-1)[:n].reshape(shape)


def _channel_axis(shape, min_channel: int = _MIN_CHANNEL) -> int:
    """Trailing channel length used for per-channel reconstruction, or 0
    when the leaf is too small / scalar and should use the flat layout."""
    if len(shape) == 0:
        return 0
    b = shape[-1] if len(shape) > 1 else shape[0]
    return b if b >= min_channel else 0


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Stateless descriptor; EF state travels explicitly through the step.

    ``ef_gain``      onebit EF over-relaxation (compress ``g + ef_gain*e``).
    ``min_channel``  minimum trailing-axis length for per-channel two-bin
                     reconstruction instead of the flat 256-lane layout.
    ``backend``      kernel backend seam: auto | kernel | ref."""
    method: str = "none"
    density: float = 0.01        # dgc
    s_levels: int = 127          # qsgd
    clip_sigma: float = 2.5      # terngrad
    backend: str = "auto"
    ef_gain: float = 2.0
    min_channel: int = _MIN_CHANNEL

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"compression method {self.method!r} not in "
                             f"{METHODS}")

    # ---------------------------------------------------------------- state
    def init_state(self, leaves: Iterable[torch.Tensor]
                   ) -> Optional[List[torch.Tensor]]:
        """Zero EF residuals (fp32, one per leaf), or None without EF."""
        if self.method in EF_METHODS:
            return [torch.zeros_like(g, dtype=torch.float32) for g in leaves]
        return None

    @property
    def needs_rng(self) -> bool:
        return self.method in ("terngrad", "qsgd")

    # ------------------------------------------------------------- roundtrip
    def roundtrip(self, grads: Iterable[torch.Tensor],
                  state: Optional[Sequence[torch.Tensor]],
                  gen: Optional[torch.Generator] = None
                  ) -> Tuple[List[torch.Tensor], Optional[List], int]:
        """Compress+decompress each leaf (what a worker transmits vs keeps).

        ``grads`` is the leaf list, or any iterable of leaves: a generator
        lets the caller free each gradient once it is encoded.  ``gen``
        drives the stochastic methods (terngrad, qsgd).  Returns
        (decompressed leaves, new state, wire_bytes_total)."""
        if self.method == "none":
            grads = list(grads)
            return grads, state, sum(self.wire_bytes(g.shape) for g in grads)
        outs, new_state, wire = [], [], 0
        for i, g in enumerate(grads):
            o, ne = self._leaf(g, None if state is None else state[i], gen)
            outs.append(o.to(g.dtype))
            new_state.append(ne)
            wire += self.wire_bytes(g.shape)
            del g, o, ne
        return outs, (new_state if state is not None else None), wire

    def wire_bytes(self, shape) -> int:
        """Bytes one leaf of ``shape`` puts on the wire (shape-static: the
        ``wire_bytes`` part of ``roundtrip``'s accounting)."""
        n = int(np.prod(shape)) if len(shape) else 1
        if self.method == "none":
            return 4 * n
        if self.method == "terngrad":
            return KT.wire_bytes(n)
        if self.method == "qsgd":
            return KQ.wire_bytes(n, self.s_levels)
        chan = _channel_axis(shape, self.min_channel)
        plane = -(-n // 8) + 8 * (n // chan) if chan else 0
        if self.method == "dgc":
            return KK.wire_bytes(n, self.density) + plane
        return plane if chan else K1.wire_bytes(n)

    # ------------------------------------------------------ onebit internals
    def _onebit_plane(self, m, valid=None):
        """1-bit compress a row-major [R, C] block: transmitted signs plus
        the two-bin reconstruction (masked to ``valid``).  Returns
        (recon [R, C], wire_bytes): one fused encode pass, no residual."""
        _, _, _, out, _ = K1.encode_ef(m, None, valid, backend=self.backend)
        return out, -(-m.numel() // 8) + 8 * m.shape[0]

    def _leaf_onebit(self, g, e):
        """One fused encode+EF pass per leaf: returns (out, new_e), both
        shaped like ``g``."""
        shape = g.shape
        chan = _channel_axis(shape, self.min_channel)
        if chan:
            _, _, _, out, new_e = K1.encode_ef(
                g.float().reshape(-1, chan), e.float().reshape(-1, chan),
                gain=self.ef_gain, backend=self.backend)
            return out.reshape(shape), new_e.reshape(shape)
        g2, n = _to2d(g)
        e2, _ = _to2d(e)
        # the flat fallback keeps the seed's symmetric sign*mean|c| plane
        _, _, _, out, new_e = K1.encode_ef(g2, e2, gain=self.ef_gain,
                                           symmetric=True,
                                           backend=self.backend)
        return _from2d(out, n, shape), _from2d(new_e, n, shape)

    def _leaf_dgc(self, g, e):
        """Sparse top values of ``c = g + e`` above the density quantile,
        plus (channel-wise leaves) a 1-bit plane of the remainder masked
        to the unsent slots.  Returns (out, new_e = c - out)."""
        shape = g.shape
        ctrue = g.float() + e.float()
        g2, n = _to2d(g)
        e2, _ = _to2d(e)
        # quantile of the unpadded compensated gradient
        th = KK.threshold_for_density(g, e, self.density)
        kept2, _ = KK.sparsify(g2, e2, th, backend=self.backend)
        kept = _from2d(kept2, n, shape)
        del g2, e2, kept2
        chan = _channel_axis(shape, self.min_channel)
        if chan:
            rem = (ctrue - kept).reshape(-1, chan)
            # kept slots were sent exactly: masked out of the bin means
            unsent = kept.reshape(-1, chan) == 0.0
            remq, _ = self._onebit_plane(rem, valid=unsent)
            remq = torch.where(unsent, remq, 0.0)
            out = kept + remq.reshape(shape)
        else:
            out = kept
        return out, ctrue - out

    # ----------------------------------------------------------------- leaf
    def _leaf(self, g, e, gen=None, u=None):
        """One leaf: (out shaped like ``g``, new EF residual or None).
        terngrad and qsgd draw ``u`` (the flat [rows, 256] layout) from
        ``gen`` unless it is given."""
        if self.method == "onebit":
            return self._leaf_onebit(g, e)
        if self.method == "dgc":
            return self._leaf_dgc(g, e)
        g2, n = _to2d(g.float())
        if u is None:
            u = torch.rand(g2.shape, generator=gen, device=g2.device)
        if self.method == "terngrad":
            if resolve_backend(self.backend, g2) == "kernel":
                t, s = KT.compress(g2, u, clip_sigma=self.clip_sigma)
            else:
                t, s = KT.terngrad_ref(g2, u, self.clip_sigma)
            return _from2d(KT.decompress(t, s), n, g.shape), None
        if self.method == "qsgd":
            q, norm = KQ.quantize(g2, u, s_levels=self.s_levels,
                                  backend=self.backend)
            out = KQ.decompress(q, norm, s_levels=self.s_levels)
            return _from2d(out, n, g.shape), None
        raise ValueError(self.method)
