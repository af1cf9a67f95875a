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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels.flash_attention.flash_attention import (SMS,
                                                                 decode_chunk)
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
    chunk = decode_chunk(B, L, KV)
    assert chunk == want and chunk % 16 == 0 and 16 <= chunk <= 128
    blocks = -(-L // chunk) * KV * B
    assert blocks >= 2 * SMS or chunk == 16
