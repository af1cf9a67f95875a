"""Model configuration for the PyTorch port.

The port serves decoder-only dense / GQA models, so this ``ModelConfig``
keeps the fields those models read, with the same names, defaults and
``reduced()`` rule as the JAX package's config.  The MoE, MLA, recurrent
and encoder-decoder fields arrive with the families that read them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense (the families the port serves)
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # ---- attention ----
    num_heads: int = 0               # query heads
    num_kv_heads: int = 0
    head_dim: int = 0
    attn_type: str = "gqa"
    rope_theta: float = 10_000.0
    # ---- MLP ----
    act: str = "swiglu"
    # ---- layer stack ----
    block_pattern: Tuple[str, ...] = ("attn",)   # per-layer block kinds, cycled
    # ---- misc ----
    attn_backend: str = "auto"       # kernel backend seam: auto|kernel|ref
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    use_bias: bool = False
    tie_embeddings: bool = True
    source: str = ""                 # citation for the config

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Concrete per-layer block kind for each of num_layers layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def param_count(self) -> int:
        """Analytic parameter count of the dense decoder (the JAX
        package's count: the final norm is left out)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n = V * d * (1 if self.tie_embeddings else 2)
        per_layer = (2 * d + d * self.num_heads * hd
                     + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
                     + (3 if self.act == "swiglu" else 2) * d * ff)
        return int(n + self.num_layers * per_layer)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family variant for CPU tests (the JAX package's
        rule for the fields kept here)."""
        small = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 128),
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
        )
        if self.num_heads:
            heads = min(self.num_heads, 4)
            kv = max(1, min(self.num_kv_heads, heads))
            small.update(num_heads=heads, num_kv_heads=kv,
                         head_dim=min(self.head_dim or 32, 32))
        small.update(overrides)
        return dataclasses.replace(self, **small)
