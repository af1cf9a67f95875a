"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (the ``cuda`` fixture skips on a host
without one) and imports no JAX, so the file runs on the card's host:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerances: fp32 within 1e-4 (the summation order differs); bf16 within
2e-2 (one bf16 ulp at |out| ~ 2, fp32 accumulation on both sides).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import build_model

TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=gen.device).to(dtype)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S,H,KV", [(100, 8, 2), (64, 4, 4), (300, 32, 4)])
def test_flash_attention_matches_plain(cuda, dtype, hd, S, H, KV):
    gen = torch.Generator(device=cuda).manual_seed(S + hd)
    B = 2
    q = _randn(gen, dtype, B, S, H, hd)
    k, v = _randn(gen, dtype, B, S, KV, hd), _randn(gen, dtype, B, S, KV, hd)
    FA.reset_launches()
    for causal, window in ((True, 0), (True, 16), (False, 0)):
        out = FA.attention(q, k, v, causal=causal, window=window)
        ref = FA.attention_ref(q, k, v, causal=causal, window=window)
        assert out.dtype == dtype and out.shape == q.shape
        assert _err(out, ref) <= TOLS[dtype], (causal, window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("H,KV", [(8, 8), (32, 4), (32, 1)])
def test_flash_decode_matches_plain(cuda, dtype, hd, H, KV):
    gen = torch.Generator(device=cuda).manual_seed(H * KV + hd)
    B, L = 4, 200
    q = _randn(gen, dtype, B, 1, H, hd)
    ck, cv = _randn(gen, dtype, B, L, KV, hd), _randn(gen, dtype, B, L, KV, hd)
    FA.reset_launches()
    for window, pos in ((0, [0, 63, 64, 199]), (0, [5, 300, 17, 130]),
                        (L, [3, 199, 200, 517])):
        pos = torch.tensor(pos, device=cuda)
        out = FA.decode(q, ck, cv, pos, window=window)
        ref = FA.decode_ref(q, ck, cv, pos, window=window)
        assert _err(out, ref) <= TOLS[dtype], (window, pos)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_decode"] == 3


def test_kernel_rejects_unsupported_head_dim(cuda):
    q = torch.zeros(1, 4, 4, 48, device=cuda)       # head_dim 48: no kernel
    with pytest.raises(ValueError, match="head_dim"):
        FA.attention(q, q, q)


def test_model_kernel_path_matches_ref_path(cuda):
    """Reduced TinyLlama in fp32 on the card: the kernel path (auto on
    CUDA) and the plain path agree within 1e-4 and give the same greedy
    tokens through prefill + 4 decode steps."""
    cfg = get_config("tinyllama-1.1b").reduced(num_kv_heads=2)
    model = build_model(cfg)
    ref_model = build_model(dataclasses.replace(cfg, attn_backend="ref"))
    params = model.init(seed=0, device=cuda)
    tokens = torch.randint(1, cfg.vocab_size, (3, 9), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    outs = []
    for m in (model, ref_model):
        logits, st = m.prefill(params, tokens, compute_dtype=torch.float32)
        caches = m.cache_from_prefill(st, 16, dtype=torch.float32)
        seq = [logits]
        for step in range(4):
            tok = seq[-1][..., :cfg.vocab_size].argmax(-1)
            pos = torch.full((3,), 9 + step, device=cuda)
            logits, caches = m.decode_step(params, caches, tok, pos,
                                           compute_dtype=torch.float32)
            seq.append(logits)
        outs.append(torch.cat(seq, 1))
    assert _err(outs[0], outs[1]) <= 1e-4
    assert torch.equal(outs[0].argmax(-1), outs[1].argmax(-1))
