"""The split-K decode's algorithm on the CPU.

``csrc/flash_decode.cu`` splits the cache into chunks, writes a partial
(m, l, acc) per chunk and query head, and merges the partials in a second
kernel.  ``ref.decode_split_ref`` is that algorithm in plain PyTorch; here
it is held against the JAX package's ``flash_decode`` (the Pallas kernel in
interpret mode, one call per row's position, as
tests/test_torch_kernels.py runs it) and against ``decode_ref``, in fp32
within 1e-5 (only the summation order differs), at chunks of 16, 64 and
128 rows, on a full cache and a ring buffer, with positions that leave
whole chunks masked (their partial is empty and must weigh 0, not NaN).

The fp32 prefill kernel (``csrc/flash_attention.cu``) runs both of its
products on the tensor cores in 3xTF32.  ``_attention_3xtf32`` repeats
that arithmetic here (TF32 rounding by the ``cvt.rna`` rule on the bits,
the three products, the softmax with scale and log2 e folded into one
exponent of 2) and is held against JAX's ``flash_attention`` within 1e-4,
the card's fp32 tolerance, before any card time is spent on it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import math

from repro.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels.flash_attention.flash_attention import decode_chunk
from repro_torch.kernels.flash_attention.ref import decode_split_ref

torch.set_num_threads(2)

TOL = 1e-5


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# (window, L, positions): a full cache with positions on both sides of
# the 16-, 64- and 128-row chunk edges and past L; a ring buffer written
# only partly (pos < W: the chunks past pos hold unwritten slots) and one
# that has wrapped (pos >= W)
CASES = [
    (0, 200, [0, 15, 16, 63, 64, 127, 128, 250]),
    (0, 144, [5, 17, 65, 143]),
    (144, 144, [0, 15, 16, 70]),
    (144, 144, [127, 128, 143, 400]),
]


@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("window,L,pos", CASES)
@pytest.mark.parametrize("KV", [1, 2])
def test_split_decode_matches_jax(chunk, window, L, pos, KV):
    rng = np.random.RandomState(L + chunk + KV)
    H, hd = 4, 32
    q = _randn(rng, len(pos), 1, H, hd)
    ck, cv = _randn(rng, len(pos), L, KV, hd), _randn(rng, len(pos), L, KV, hd)
    tq, tck, tcv = map(torch.from_numpy, (q, ck, cv))
    tpos = torch.tensor(pos)
    split = decode_split_ref(tq, tck, tcv, tpos, window=window, chunk=chunk)
    assert split.dtype == torch.float32 and torch.isfinite(split).all()
    plain = TFA.decode_ref(tq, tck, tcv, tpos, window=window)
    assert _max_err(split, plain) <= TOL
    split = split.numpy()
    for b, p in enumerate(pos):
        args = (jnp.asarray(q[b:b + 1]), jnp.asarray(ck[b:b + 1]),
                jnp.asarray(cv[b:b + 1]), jnp.int32(p))
        pallas = FA.decode(*args, window=window, block_k=16)
        oracle = FA.decode_ref(*args, window=window)
        assert _max_err(split[b:b + 1], pallas) <= TOL, (b, p)
        assert _max_err(split[b:b + 1], oracle) <= TOL, (b, p)


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_empty_partials_weigh_nothing(chunk):
    """Only row 0 of a 256-row cache is visible (pos 0, full cache; and a
    ring buffer at pos 0): every other chunk's partial is empty, and the
    output is that row's value exactly, finite."""
    rng = np.random.RandomState(chunk)
    q = torch.from_numpy(_randn(rng, 2, 1, 4, 32))
    ck, cv = (torch.from_numpy(_randn(rng, 2, 256, 2, 32)) for _ in range(2))
    pos = torch.tensor([0, 0])
    for window in (0, 256):
        out = decode_split_ref(q, ck, cv, pos, window=window, chunk=chunk)
        want = cv[:, :1].repeat_interleave(2, dim=2)      # [2, 1, 4, 32]
        assert torch.isfinite(out).all()
        assert torch.equal(out, want), window


@pytest.mark.parametrize("B,L,KV,want", [
    (8, 576, 4, 64),        # the serving shape: 9 x 4 x 8 = 288 blocks
    (8, 2048, 4, 128),      # full context: 16 x 4 x 8 = 512 blocks
    (1, 2048, 1, 16),       # one row, one KV head: 128 blocks of 16 rows
    (4, 200, 2, 16),
    (64, 576, 4, 128),      # many rows: the largest chunk, 1280 blocks
])
def test_decode_chunk_fills_the_card(B, L, KV, want):
    sms = 132                                       # an H100 SXM
    chunk = decode_chunk(B, L, KV, sms)
    assert chunk == want and chunk % 16 == 0 and 16 <= chunk <= 128
    blocks = -(-L // chunk) * KV * B
    assert blocks >= 2 * sms or chunk == 16


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: add half a TF32 ulp
    to the bits and clear the low 13 (nearest, ties away from zero)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_3xtf32(a, b):
    """a @ b with each operand split into a TF32 high part and a TF32
    remainder; lo*hi + hi*lo + hi*hi in fp32, the kernel's order."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm_1xtf32(a, b):
    """a @ b as one TF32 product: the high parts alone."""
    return _tf32(a) @ _tf32(b)


def _attention_3xtf32(q, k, v, causal, window, mm=_mm_3xtf32):
    """The fp32 kernel's arithmetic on numpy fp32 [B, S, H, hd] inputs
    (``mm`` computes both products)."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    qt = q.transpose(0, 2, 1, 3)
    kt = np.repeat(k, rep, axis=2).transpose(0, 2, 3, 1)
    vt = np.repeat(v, rep, axis=2).transpose(0, 2, 1, 3)
    s = mm(qt, kt)                                   # raw scores [B,H,S,S]
    if causal:
        qi, kj = np.arange(S)[:, None], np.arange(S)[None, :]
        mask = kj <= qi
        if window:
            mask &= kj > qi - window
        s = np.where(mask, s, np.float32(-np.inf))
    c = np.float32(math.log2(math.e) / math.sqrt(hd))
    m = s.max(-1, keepdims=True)
    p = np.exp2(s * c - m * c).astype(np.float32)
    o = mm(p, vt) / p.sum(-1, keepdims=True)
    return o.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,scale", [
    (2, 64, 4, 2, 32, True, 0, 1.0),       # GQA, causal
    (1, 100, 4, 1, 64, True, 16, 1.0),     # a window across blocks
    (2, 48, 2, 2, 32, False, 0, 1.0),      # full attention
    (1, 80, 4, 2, 128, True, 0, 1.0),      # hd 128
    (1, 64, 4, 2, 64, True, 0, 4.0),       # |q.k| / sqrt(hd) ~ 16
])
def test_3xtf32_attention_within_tolerance(B, S, H, KV, hd, causal, window,
                                           scale):
    rng = np.random.RandomState(S + hd)
    q = _randn(rng, B, S, H, hd) * np.float32(scale)
    k = _randn(rng, B, S, KV, hd) * np.float32(scale)
    v = _randn(rng, B, S, KV, hd)
    out = _attention_3xtf32(q, k, v, causal, window)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    pallas = FA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                interpret=True)
    assert _max_err(out, pallas) <= 1e-4
    # one TF32 product misses it
    one = _attention_3xtf32(q, k, v, causal, window, mm=_mm_1xtf32)
    assert _max_err(one, pallas) > 1e-4
