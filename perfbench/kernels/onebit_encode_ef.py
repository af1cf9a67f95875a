"""The fused 1-bit encode with error feedback (``onebit_encode_ef.cu``):
one launch over [R, C] fp32 rows, each row quantized to its signs and two
bin means.

Bytes: the rows read (4 B an element), the optional residual (4 B) and
mask of real elements (1 B), and the outputs written: signs (1 B), the
decoded rows (4 B), the new residual (4 B) and two fp32 means a row."""

KERNEL = "onebit_encode_ef_kernel"


def nbytes(R: int, C: int, residual: bool = False, mask: bool = False) -> float:
    per = 4 + 1 + 4 + 4 + (4 if residual else 0) + (1 if mask else 0)
    return float(R * C * per + 8 * R)
