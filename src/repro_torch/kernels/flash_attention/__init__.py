"""Flash attention: prefill (with a trainable entry) and one-token decode
(CUDA kernels + plain PyTorch versions)."""
from repro_torch.kernels.flash_attention.ops import (LAUNCHES, attention,
                                                     attention_grad,
                                                     attention_ref, decode,
                                                     decode_ref,
                                                     reset_launches)

__all__ = ["LAUNCHES", "attention", "attention_grad", "attention_ref",
           "decode", "decode_ref", "reset_launches"]
