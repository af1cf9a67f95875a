"""The causal flash-attention forward (``flash_attention.cu``): one launch
over a [B, S, H, hd] query block against [B, S, KV, hd] keys and values.

Operations: the S (S + 1) / 2 attended (query, key) pairs of each row and
head, 2 hd multiply-adds each for the scores and for the weighted values,
counted as 2 operations per multiply-add.  Bytes: q, k and v read once and
the output written once."""

KERNELS = {"float32": "flash_attention_f32_kernel",
           "bfloat16": "flash_attention_bf16_kernel"}


def flops(B: int, S: int, H: int, hd: int) -> float:
    return 4.0 * hd * H * B * S * (S + 1) / 2


def nbytes(B: int, S: int, H: int, KV: int, hd: int, itemsize: int) -> float:
    return float((2 * B * S * H * hd + 2 * B * S * KV * hd) * itemsize)
