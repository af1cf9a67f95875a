"""The split-K decode attention (``flash_decode.cu``, its split pass and
its combine): one query token per batch row against that row's cache.

Bytes: each row's keys and values up to and with its position (the cache
length the row needs), the queries read and the outputs written.  The
fp32 partials between the two passes are the kernel's own traffic and are
not counted.  Operations: 4 hd per cached position and head."""

KERNELS = ("flash_decode_split_kernel", "flash_decode_combine_kernel")


def nbytes(lengths, rows: int, H: int, KV: int, hd: int,
           itemsize: int) -> float:
    return float((sum(lengths) * 2 * KV * hd + 2 * rows * H * hd) * itemsize)


def flops(lengths, H: int, hd: int) -> float:
    return 4.0 * hd * H * sum(lengths)
