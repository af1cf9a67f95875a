"""Model configuration of the port (the JAX package's ``configs/base.py``).

Every architecture of the JAX package is expressed as a ``ModelConfig``
with the same fields, defaults, ``param_count``, ``active_param_count``
and ``reduced()`` rule, so a config means the same network in both
packages.  The families the port's models do not run yet raise in
``models.transformer.plan_segments``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # ---- attention ----
    num_heads: int = 0               # query heads; 0 => attention-free (ssm)
    num_kv_heads: int = 0
    head_dim: int = 0
    attn_type: str = "gqa"           # gqa | mla | none
    window: int = 0                  # >0 => sliding-window (local) attention
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) half-dims
    # ---- MLP / MoE ----
    act: str = "swiglu"              # swiglu | gelu
    moe: bool = False
    num_experts: int = 0             # routed experts
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    first_k_dense: int = 0           # leading dense layers before the MoE stack
    capacity_factor: float = 1.0
    router_aux_coef: float = 0.01
    # ---- MLA (deepseek) ----
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # ---- hybrid / ssm ----
    block_pattern: Tuple[str, ...] = ("attn",)   # per-layer block kinds, cycled
    lru_width: int = 0               # RG-LRU state width (recurrentgemma)
    conv_width: int = 4              # temporal conv in recurrent block
    rwkv_head_size: int = 64
    # ---- encoder-decoder (whisper) ----
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    max_source_positions: int = 1500
    # ---- misc ----
    attn_backend: str = "auto"       # kernel backend seam: auto|kernel|ref
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    use_bias: bool = False
    tie_embeddings: bool = True
    max_position_embeddings: int = 1_048_576
    learned_positions: bool = False  # whisper decoder
    source: str = ""                 # citation for the config

    # ------------------------------------------------------------------ helpers
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Concrete per-layer block kind for each of num_layers layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def padded_vocab(self, shards: int) -> int:
        """Vocab padded to a multiple of the model-axis shard count."""
        v = self.vocab_size
        return ((v + shards - 1) // shards) * shards

    def param_count(self) -> int:
        """Analytic total parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, ff, L, V = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        n = V * d  # embedding
        if not self.tie_embeddings:
            n += V * d
        per_layer = []
        for kind in self.layer_kinds:
            p = 2 * d  # norms
            if kind == "attn" or kind == "local":
                if self.attn_type == "mla":
                    r, q_heads = self.kv_lora_rank, self.num_heads
                    p += d * (r + self.qk_rope_dim)
                    p += r * q_heads * (self.qk_nope_dim + self.v_head_dim)
                    p += d * q_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    p += q_heads * self.v_head_dim * d
                else:
                    hd = self.head_dim
                    p += d * self.num_heads * hd           # q
                    p += 2 * d * self.num_kv_heads * hd    # k, v
                    p += self.num_heads * hd * d           # o
            elif kind == "rglru":
                w = self.lru_width or d
                p += 2 * d * w + w * d                     # in/out projections
                p += self.conv_width * w + 3 * w           # conv + gates
            elif kind == "rwkv":
                H = d // self.rwkv_head_size
                p += 6 * d * d + H * self.rwkv_head_size   # r,k,v,g,o,w + ln
            if kind == "rwkv":
                p += 2 * d * ff                            # channel mix (k, v)
            elif self.moe and kind != "rwkv":
                p += d * self.num_experts                  # router
                e_ff = self.moe_d_ff
                n_e = self.num_experts + self.num_shared_experts
                p += n_e * 3 * d * e_ff
            else:
                mult = 3 if self.act == "swiglu" else 2
                p += mult * d * ff
            per_layer.append(p)
        n += sum(per_layer)
        if self.is_encoder_decoder:
            # encoder self-attn + mlp, decoder cross-attn already excluded above;
            # approximate: encoder layers mirror decoder self-attn+mlp, plus
            # decoder cross-attention.
            hd = self.head_dim
            enc = self.encoder_layers * (
                2 * d + d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d + 2 * d * ff
            )
            cross = self.num_layers * (
                d + d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d
            )
            n += enc + cross
        return int(n)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: routed experts counted at top-k)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        # remove inactive routed experts
        e_ff = self.moe_d_ff
        n_moe_layers = self.num_layers - self.first_k_dense
        inactive = (self.num_experts - self.experts_per_token)
        full -= n_moe_layers * inactive * 3 * self.d_model * e_ff
        return int(full)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        small = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 128),
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            max_source_positions=min(self.max_source_positions, 16),
        )
        if self.num_heads:
            heads = min(self.num_heads, 4)
            kv = max(1, min(self.num_kv_heads, heads))
            small.update(num_heads=heads, num_kv_heads=kv,
                         head_dim=min(self.head_dim or 32, 32))
        if self.moe:
            small.update(num_experts=min(self.num_experts, 4),
                         experts_per_token=min(self.experts_per_token, 2),
                         num_shared_experts=min(self.num_shared_experts, 1),
                         moe_d_ff=min(self.moe_d_ff, 64),
                         first_k_dense=min(self.first_k_dense, 1))
        if self.attn_type == "mla":
            small.update(kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=16,
                         v_head_dim=32, q_lora_rank=0)
        if self.lru_width:
            small.update(lru_width=128)
        if self.family == "ssm":
            small.update(rwkv_head_size=32)
        if self.is_encoder_decoder:
            small.update(encoder_layers=min(self.encoder_layers, 2))
        if self.window:
            small.update(window=8)
        if self.mrope_sections:
            # sections sum to head_dim//2 = 16
            small.update(mrope_sections=(4, 6, 6))
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str         # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
