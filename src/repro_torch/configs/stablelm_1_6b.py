"""StableLM 2 1.6B — dense, MHA (kv == q heads) [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,       # full MHA
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    act="swiglu",
    norm="layernorm",      # stablelm-2 uses LayerNorm
    rope_theta=10_000.0,
    use_bias=False,
    tie_embeddings=False,
    source="hf:stabilityai/stablelm-2-1_6b",
)
