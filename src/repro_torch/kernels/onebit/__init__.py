"""1-bit gradient compression with error feedback: the CUDA kernels
``onebit_compress`` (symmetric) and ``onebit_encode_ef`` (fused encode +
EF) and their plain PyTorch versions."""
from repro_torch.kernels.onebit.ops import (LAUNCHES, compress, decompress,
                                            encode_ef, onebit_encode_ef_ref,
                                            onebit_ref, pack_bits,
                                            reset_launches, unpack_bits,
                                            wire_bytes)

__all__ = ["LAUNCHES", "compress", "decompress", "encode_ef",
           "onebit_encode_ef_ref", "onebit_ref", "pack_bits",
           "reset_launches", "unpack_bits", "wire_bytes"]
