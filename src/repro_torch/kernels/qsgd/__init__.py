"""QSGD s-level stochastic quantization: the CUDA kernel ``qsgd_compress``
and its plain PyTorch version."""
from repro_torch.kernels.qsgd.ops import (LAUNCHES, compress, decompress,
                                          qsgd_ref, quantize, reset_launches,
                                          wire_bytes)

__all__ = ["LAUNCHES", "compress", "decompress", "qsgd_ref", "quantize",
           "reset_launches", "wire_bytes"]
