"""The port's flash-attention entries against the JAX package's.

On the CPU, ``repro_torch``'s ``attention`` / ``decode`` run their plain
PyTorch versions; they are held against the Pallas kernels (interpret
mode, as tests/test_kernels.py runs them) and the JAX oracles on the same
numpy inputs, within 1e-5 in fp32 (only the summation order differs).
The CUDA kernels themselves are held against the plain versions in
tests/test_torch_cuda.py, which imports no JAX so that it runs on the
card's host.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels.backend import resolve_backend

torch.set_num_threads(2)

TOL = 1e-5


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# ------------------------------------------------------------- prefill
@pytest.mark.parametrize("S", [24, 37])
@pytest.mark.parametrize("KV", [1, 2, 4])
@pytest.mark.parametrize("mode", ["causal", "window", "full"])
def test_attention_matches_jax(S, KV, mode):
    rng = np.random.RandomState(S * 10 + KV)
    B, H, hd = 2, 4, 32
    q, k, v = (_randn(rng, B, S, H, hd), _randn(rng, B, S, KV, hd),
               _randn(rng, B, S, KV, hd))
    causal, window = mode != "full", (8 if mode == "window" else 0)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = FA.attention(jq, jk, jv, causal=causal, window=window,
                          block_q=32, block_k=32)
    oracle = FA.attention_ref(jq, jk, jv, causal=causal, window=window)
    port = TFA.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal, window=window)
    assert port.dtype == torch.float32 and port.shape == (B, S, H, hd)
    assert _max_err(port, pallas) <= TOL
    assert _max_err(port, oracle) <= TOL


# -------------------------------------------------------------- decode
def _decode_case(rng, B, L, KV, H=4, hd=32):
    return (_randn(rng, B, 1, H, hd), _randn(rng, B, L, KV, hd),
            _randn(rng, B, L, KV, hd))


@pytest.mark.parametrize("KV", [1, 2, 4])
@pytest.mark.parametrize("window,pos", [
    (0, [0, 5, 23, 11]),            # full cache, a position per row
    (8, [3, 7, 8, 19]),             # ring buffer, pos below and above W
])
def test_decode_per_row_pos_matches_jax(KV, window, pos):
    """Each row decodes at its own position; every row equals a JAX run
    with that row's scalar position."""
    rng = np.random.RandomState(KV + window)
    L = window or 24
    q, ck, cv = _decode_case(rng, len(pos), L, KV)
    port = TFA.decode(torch.from_numpy(q), torch.from_numpy(ck),
                      torch.from_numpy(cv), torch.tensor(pos),
                      window=window).numpy()
    for b, p in enumerate(pos):
        args = (jnp.asarray(q[b:b + 1]), jnp.asarray(ck[b:b + 1]),
                jnp.asarray(cv[b:b + 1]), jnp.int32(p))
        pallas = FA.decode(*args, window=window, block_k=8)
        oracle = FA.decode_ref(*args, window=window)
        assert _max_err(port[b:b + 1], pallas) <= TOL, (b, p)
        assert _max_err(port[b:b + 1], oracle) <= TOL, (b, p)


# ------------------------------------------------------------- the seam
def test_backend_seam_follows_the_device():
    t = torch.zeros(1)
    assert resolve_backend("auto", t) == "ref"
    assert resolve_backend("ref", t) == "ref"
    with pytest.raises(ValueError, match="CUDA tensor"):
        resolve_backend("kernel", t)
    with pytest.raises(ValueError):
        resolve_backend("pallas", t)


def test_ops_reject_bad_shapes():
    q = torch.zeros(1, 4, 4, 32)
    with pytest.raises(ValueError):
        TFA.attention(q, torch.zeros(1, 4, 3, 32), torch.zeros(1, 4, 3, 32))
    with pytest.raises(ValueError):
        TFA.decode(q, torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32),
                   torch.zeros(1, dtype=torch.long))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler, no kernels: the build raises instead of falling back."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
