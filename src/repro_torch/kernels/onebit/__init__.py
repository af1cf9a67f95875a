"""1-bit gradient compression with error feedback: the fused encode+EF
CUDA kernel and its plain PyTorch version."""
from repro_torch.kernels.onebit.ops import (LAUNCHES, encode_ef,
                                            onebit_encode_ef_ref, pack_bits,
                                            reset_launches, unpack_bits,
                                            wire_bytes)

__all__ = ["LAUNCHES", "encode_ef", "onebit_encode_ef_ref", "pack_bits",
           "reset_launches", "unpack_bits", "wire_bytes"]
