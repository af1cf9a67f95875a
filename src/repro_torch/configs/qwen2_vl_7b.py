"""Qwen2-VL 7B — VLM backbone with M-RoPE [arXiv:2409.12191].

The vision encoder (ViT + merger) is a STUB per the brief: `input_specs`
provides precomputed patch embeddings of shape (batch, n_patches, d_model)
that the backbone merges into the token stream.  M-RoPE splits each rotary
half-dim (head_dim/2 = 64) into (temporal, height, width) = (16, 24, 24)
sections driven by 3-row position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,        # GQA
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # sums to head_dim // 2
    use_bias=True,                 # qwen2 uses qkv bias
    tie_embeddings=False,
    source="arXiv:2409.12191 (Qwen2-VL)",
)
