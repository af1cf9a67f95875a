"""DeepSeek-V2-Lite 16B — MLA + fine-grained MoE [arXiv:2405.04434].

Assignment spec: 27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
MoE 64e top-6, MLA kv_lora=512, "2 shared + 160 routed top-6".
Note: the assignment's "160 routed" matches DeepSeek-V2 (full), while 64e
matches V2-Lite; we follow the V2-Lite model card (64 routed + 2 shared,
top-6), which is consistent with the "deepseek-v2-lite-16b" identity and the
64e field.  MLA dims follow the model card: q/k nope 128, rope 64, v 128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,       # MLA: kv heads == q heads after up-projection
    head_dim=192,          # qk_nope (128) + qk_rope (64)
    attn_type="mla",
    kv_lora_rank=512,
    q_lora_rank=0,         # V2-Lite has no q compression
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    d_ff=10944,            # dense prefix layer width (model card)
    vocab_size=102400,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    moe=True,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    first_k_dense=1,
    capacity_factor=1.0,
    tie_embeddings=False,
    source="arXiv:2405.04434 (DeepSeek-V2); hf:deepseek-ai/DeepSeek-V2-Lite",
)
