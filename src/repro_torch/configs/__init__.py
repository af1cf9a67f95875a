"""Architecture registry of the port: ``--arch <id>`` resolves here (the
JAX package's ``configs/__init__.py``)."""
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _deepseek
from repro_torch.configs.qwen2_vl_7b import CONFIG as _qwen2vl
from repro_torch.configs.stablelm_1_6b import CONFIG as _stablelm
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6
from repro_torch.configs.command_r_35b import CONFIG as _commandr
from repro_torch.configs.llama3_2_3b import CONFIG as _llama32

ARCHS = {c.name: c for c in [
    _tinyllama, _kimi, _whisper, _deepseek, _qwen2vl,
    _stablelm, _recurrentgemma, _rwkv6, _commandr, _llama32,
]}

# (arch, shape) pairs that are architecturally meaningless
SKIPS = {
    ("whisper-large-v3", "long_500k"):
        "encoder-decoder ASR with 30s/448-token context; 500k decode is N/A",
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


def all_pairs(include_skips: bool = False):
    for a in ARCHS:
        for s in INPUT_SHAPES:
            if not include_skips and (a, s) in SKIPS:
                continue
            yield a, s


__all__ = ["ARCHS", "INPUT_SHAPES", "InputShape", "ModelConfig", "SKIPS",
           "all_pairs", "get_config", "get_shape"]
