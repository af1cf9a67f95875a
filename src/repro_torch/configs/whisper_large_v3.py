"""Whisper large-v3 — encoder-decoder ASR backbone [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is a STUB per the brief:
`input_specs` provides precomputed frame embeddings of shape
(batch, 1500, d_model) for the encoder.  The decoder is a standard
transformer with learned positions and cross-attention.
`long_500k` is skipped for this arch (30 s / 448-token context model;
see ``configs.SKIPS``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,          # decoder layers
    encoder_layers=32,
    is_encoder_decoder=True,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,        # MHA
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,       # padded to the model-axis multiple at build time
    act="gelu",
    norm="layernorm",
    use_bias=True,
    learned_positions=True,
    max_source_positions=1500,
    tie_embeddings=True,
    source="arXiv:2212.04356 (Whisper); large-v3 model card",
)
