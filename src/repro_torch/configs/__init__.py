"""Architecture registry of the port: ``--arch <id>`` resolves here."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama

ARCHS = {c.name: c for c in [_tinyllama]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
