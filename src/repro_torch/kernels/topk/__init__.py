"""DGC threshold sparsification with error accumulation: the CUDA kernel
``topk_compress``, its plain PyTorch version and the quantile threshold."""
from repro_torch.kernels.topk.ops import (LAUNCHES, compress, reset_launches,
                                          sparsify, threshold_for_density,
                                          topk_ref, wire_bytes)

__all__ = ["LAUNCHES", "compress", "reset_launches", "sparsify",
           "threshold_for_density", "topk_ref", "wire_bytes"]
