"""Kimi K2 — trillion-parameter MoE, 384 routed experts top-8 [arXiv:2501.kimi2].

Assignment spec: 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840,
MoE 384e top-8.  We read d_ff=2048 as the per-expert (and shared-expert) hidden
dim, matching K2's moe_intermediate_size.  Layer 0 is dense (as in K2), with a
dense d_ff equal to the activated expert width (8 x 2048 = 16384).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,        # GQA
    head_dim=128,
    d_ff=16384,            # dense prefix layer width (~= top_k * moe_d_ff)
    vocab_size=163840,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=50_000.0,
    moe=True,
    num_experts=384,
    num_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    first_k_dense=1,
    capacity_factor=1.0,
    tie_embeddings=False,
    source="arXiv:2501.kimi2 (Kimi K2 paper-table)",
)
