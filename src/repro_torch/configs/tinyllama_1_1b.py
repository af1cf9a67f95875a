"""TinyLlama 1.1B — llama2-architecture small dense model [arXiv:2401.02385]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,        # GQA
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2401.02385 (TinyLlama)",
)
