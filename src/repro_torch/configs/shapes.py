"""The four input shapes (the JAX package's ``configs/shapes.py``)."""
from repro_torch.configs.base import (  # re-export
    INPUT_SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, InputShape,
)

__all__ = ["INPUT_SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
           "LONG_500K", "InputShape"]
