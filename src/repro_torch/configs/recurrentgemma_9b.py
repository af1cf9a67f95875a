"""RecurrentGemma 9B — Griffin: RG-LRU + local attention, 2:1 [arXiv:2402.19427].

Block pattern is (recurrent, recurrent, local-attention) cycled over 38 layers
(Griffin's "temporal mixing blocks in a ratio of 2:1").  Local attention uses
MQA (kv=1) with a 2048-token window, making `long_500k` decode sub-quadratic
with a constant-size state: RG-LRU hidden + a ring-buffer window cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,        # MQA
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    act="swiglu",          # Griffin uses GeGLU; gated-MLP structure identical
    norm="rmsnorm",
    window=2048,
    block_pattern=("rglru", "rglru", "local"),
    lru_width=4096,
    conv_width=4,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
)
