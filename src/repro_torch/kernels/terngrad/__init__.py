"""TernGrad stochastic ternarization: the CUDA kernels
``terngrad_ternarize`` and ``terngrad_compress`` and their plain PyTorch
versions."""
from repro_torch.kernels.terngrad.ops import (LAUNCHES, compress, decompress,
                                              reset_launches, ternarize,
                                              ternarize_ref, terngrad_ref,
                                              wire_bytes)

__all__ = ["LAUNCHES", "compress", "decompress", "reset_launches",
           "ternarize", "ternarize_ref", "terngrad_ref", "wire_bytes"]
