"""Command-R 35B — dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,        # GQA
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    act="swiglu",
    norm="layernorm",      # Cohere uses LayerNorm (no bias)
    use_bias=False,
    rope_theta=8_000_000.0,
    tie_embeddings=True,   # command-r ties input/output embeddings
    source="hf:CohereForAI/c4ai-command-r-v01",
)
