"""Gradient compression from survey §3.3.3 behind one leaf-list interface
with error-feedback state (the JAX package's ``core/compression.py``).

Methods of the port:

  none      : fp32 gradients as-is (the survey's baseline)
  onebit    : 1-bit SGD + error feedback        [Seide et al., 159]

``terngrad``, ``qsgd`` and ``dgc`` are named in ``METHODS`` as in the
reference, and constructing a ``Compressor`` for one of them raises: they
are ROADMAP queue A item 6, with their kernels in queue B.

The onebit math is the reference's (its module docstring explains it):
two-bin Seide reconstruction per row, rows along the tensor's trailing
channel axis when it has at least ``min_channel`` elements (else the flat
256-lane layout with the symmetric ``sign * mean|c|`` plane), and the EF
over-relaxation ``c_in = g + ef_gain * e`` with the residual measured
against ``g + e``.  Each leaf is one call of the fused encode+EF entry
``kernels.onebit.encode_ef``: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors (the ``backend`` field, as the seam resolves it).

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

_LANE = 256
# Default minimum trailing-axis length for per-channel two-bin
# reconstruction (the ``Compressor.min_channel`` field): with shorter
# channels the 8 B/row of bin means would rival the 1-bit plane itself.
_MIN_CHANNEL = 64

METHODS = ("none", "onebit", "terngrad", "qsgd", "dgc")
# methods that carry per-worker error-feedback state through the step
EF_METHODS = ("onebit", "dgc")
PORTED_METHODS = ("none", "onebit")


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
    backend: str = "auto"
    ef_gain: float = 2.0
    min_channel: int = _MIN_CHANNEL

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"compression method {self.method!r} not in "
                             f"{METHODS}")
        if self.method not in PORTED_METHODS:
            raise NotImplementedError(
                f"compression {self.method!r} is not ported yet (ROADMAP "
                "queue A item 6; its kernel is in queue B)")

    # ---------------------------------------------------------------- state
    def init_state(self, leaves: Iterable[torch.Tensor]
                   ) -> Optional[List[torch.Tensor]]:
        """Zero EF residuals (fp32, one per leaf), or None without EF."""
        if self.method in EF_METHODS:
            return [torch.zeros_like(g, dtype=torch.float32) for g in leaves]
        return None

    # ------------------------------------------------------------- roundtrip
    def roundtrip(self, grads: Iterable[torch.Tensor],
                  state: Optional[Sequence[torch.Tensor]],
                  gen: Optional[torch.Generator] = None
                  ) -> Tuple[List[torch.Tensor], Optional[List], int]:
        """Compress+decompress each leaf (what a worker transmits vs keeps).

        ``grads`` is the leaf list, or any iterable of leaves: a generator
        lets the caller free each gradient once it is encoded.  ``gen``
        drives the stochastic codecs (none of the ported methods draws).
        Returns (decompressed leaves, new state, wire_bytes_total)."""
        if self.method == "none":
            grads = list(grads)
            return grads, state, sum(self.wire_bytes(g.shape) for g in grads)
        outs, new_state, wire = [], [], 0
        for i, g in enumerate(grads):
            o, ne = self._leaf_onebit(g, state[i])
            outs.append(o.to(g.dtype))
            new_state.append(ne)
            wire += self.wire_bytes(g.shape)
            del g, o, ne
        return outs, new_state, wire

    def wire_bytes(self, shape) -> int:
        """Bytes one leaf of ``shape`` puts on the wire (shape-static: the
        ``wire_bytes`` part of ``roundtrip``'s accounting)."""
        n = int(np.prod(shape)) if len(shape) else 1
        if self.method == "none":
            return 4 * n
        chan = _channel_axis(shape, self.min_channel)
        if chan:
            return -(-n // 8) + 8 * (n // chan)
        return K1.wire_bytes(n)

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
