"""RWKV-6 "Finch" 7B — attention-free, data-dependent decay [arXiv:2404.05892].

Time-mixing keeps a per-head (head_size x head_size) state updated with a
data-dependent decay w_t, so decode state is O(1) in sequence length:
`long_500k` runs with constant memory.  64 heads of size 64 (d_model 4096).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,           # attention-free
    num_kv_heads=0,
    head_dim=0,
    attn_type="none",
    d_ff=14336,
    vocab_size=65536,
    act="relu_sq",         # RWKV channel-mix uses squared ReLU
    norm="layernorm",
    block_pattern=("rwkv",),
    rwkv_head_size=64,
    tie_embeddings=False,
    source="arXiv:2404.05892 (RWKV-6 Finch)",
)
