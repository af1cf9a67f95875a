"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (the ``cuda`` fixture skips on a host
without one) and imports no JAX, so the file runs on the card's host:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerances: fp32 within 1e-4 (the summation order differs); bf16 within
2e-2 (one bf16 ulp at |out| ~ 2, fp32 accumulation on both sides).  The
1-bit encode: signs exactly equal, the fp32 outputs within 2e-5 of the
row's largest |c_in| (bin sums over rows up to 32000 long, in another
order).  The training tests also check that gradients reach the
attention projections through the flash kernel, and the reduced
BENCH_pr10.json recipe's wire bytes and bucket count on the card.  The
stochastic segment codecs' planes are the same bits whether a launch
holds one worker's segment or four.
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
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
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
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
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


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S,H,KV", [
    (1, 4, 4), (63, 8, 2), (64, 32, 4), (65, 32, 1), (127, 8, 1),
    (128, 4, 4), (129, 32, 4), (512, 32, 8), (2048, 32, 4)])
def test_flash_attention_bf16_tile_edges(cuda, hd, S, H, KV):
    """The bf16 tensor-core kernel at lengths on both sides of its 64-key
    and 128-query tiles, H/KV of 1 to 32, windows 16 and 100 (straddling
    tile edges) and non-causal: within the bf16 tolerance, all finite."""
    dtype = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(7 * S + hd)
    B = 2
    q = _randn(gen, dtype, B, S, H, hd)
    k, v = _randn(gen, dtype, B, S, KV, hd), _randn(gen, dtype, B, S, KV, hd)
    FA.reset_launches()
    modes = ((True, 0), (True, 16), (True, 100), (False, 0))
    for causal, window in modes:
        out = FA.attention(q, k, v, causal=causal, window=window)
        ref = FA.attention_ref(q, k, v, causal=causal, window=window)
        assert out.dtype == dtype and out.shape == q.shape
        assert torch.isfinite(out).all(), (causal, window)
        assert _err(out, ref) <= TOLS[dtype], (causal, window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == len(modes)


# The fp32 (training) kernel: both products on the tensor cores in
# 3xTF32, at the training shape, TinyLlama's full context, hd 32 and 128
# (32-key tiles), a ragged S and large scores
FP32_CASES = [
    (2, 256, 32, 4, 64, True, 0, 1.0),       # the training shape
    (2, 2048, 32, 4, 64, True, 0, 1.0),
    (2, 2048, 32, 4, 64, True, 100, 1.0),
    (2, 2048, 32, 4, 64, False, 0, 1.0),
    (2, 300, 8, 2, 32, True, 0, 1.0),
    (2, 300, 8, 2, 128, True, 16, 1.0),
    (2, 200, 32, 4, 64, True, 0, 1.0),       # key padding past S
    (2, 256, 32, 4, 64, True, 0, 4.0),       # |q.k| / sqrt(hd) ~ 16
]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,scale", FP32_CASES)
def test_flash_attention_fp32_tensor_cores(cuda, B, S, H, KV, hd, causal,
                                           window, scale):
    gen = torch.Generator(device=cuda).manual_seed(S + hd + int(scale))
    q = _randn(gen, torch.float32, B, S, H, hd) * scale
    k = _randn(gen, torch.float32, B, S, KV, hd) * scale
    v = _randn(gen, torch.float32, B, S, KV, hd)
    FA.reset_launches()
    out = FA.attention(q, k, v, causal=causal, window=window)
    ref = FA.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= TOLS[torch.float32]
    assert FA.LAUNCHES["flash_attention"] == 1


def _attention_f64(q, k, v, causal):
    """Attention in float64 (the plain version computes in fp32)."""
    S, rep = q.shape[1], q.shape[2] // k.shape[2]
    k, v = (t.double().repeat_interleave(rep, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k) / q.shape[3] ** 0.5
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fp32_large_scores(cuda, causal):
    """|q.k| / sqrt(hd) ~ 64: each score sums 64 products of size ~64, and
    the fp32 plain version's own rounding is no longer small against
    1e-4, so the kernel is held against float64, within the same 1e-4."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q = _randn(gen, torch.float32, 2, 256, 32, 64) * 8.0
    k = _randn(gen, torch.float32, 2, 256, 4, 64) * 8.0
    v = _randn(gen, torch.float32, 2, 256, 4, 64)
    out = FA.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _err(out, _attention_f64(q, k, v, causal)) <= TOLS[torch.float32]


def _chunk_edge_positions(L, chunk):
    """Positions on both sides of every chunk edge of an L-row cache, the
    first and last row, and two past the end."""
    pos = {0, L - 1, L, L + 37}
    for e in range(chunk, L, chunk):
        pos |= {e - 1, e}
    return sorted(pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("L", [16, 200, 576, 2048])
def test_flash_decode_split_edges(cuda, dtype, hd, L):
    """Split-K decode with pos on both sides of every chunk edge and past
    L (8 rows at a time), with B = 1, and on a ring buffer with pos < W, so
    that whole chunks are unwritten (empty partials), and pos >= W."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        decode_chunk
    gen = torch.Generator(device=cuda).manual_seed(L + hd)
    H, KV, B = 32, 4, 8
    cases = []
    for window in (0, L):
        positions = _chunk_edge_positions(L, decode_chunk(B, L, KV))
        positions += [0] * (-len(positions) % B)
        cases += [(window, positions[i:i + B])
                  for i in range(0, len(positions), B)]
        cases += [(window, [p]) for p in (0, L // 2 - 1, L - 1, L + 3)]
    FA.reset_launches()
    for window, pos in cases:
        b = len(pos)
        q = _randn(gen, dtype, b, 1, H, hd)
        ck, cv = (_randn(gen, dtype, b, L, KV, hd) for _ in range(2))
        pos = torch.tensor(pos, device=cuda)
        out = FA.decode(q, ck, cv, pos, window=window)
        ref = FA.decode_ref(q, ck, cv, pos, window=window)
        assert torch.isfinite(out).all(), (window, pos)
        assert _err(out, ref) <= TOLS[dtype], (window, pos)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_decode"] == len(cases)


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


# ------------------------------------------------------------ training
ONEBIT_TOL = 2e-5        # of the row's largest |c_in|: bin-sum order


@pytest.mark.parametrize("R,C,has_e,has_valid,symmetric", [
    (2048, 32000, True, False, False),      # lm_head leaf
    (22, 2048, True, False, False),         # stacked norms
    (300, 5632, True, True, False),         # w_gate rows, masked
    (1000, 256, True, False, True),         # flat symmetric layout
    (513, 256, False, True, False),         # codec: e=None + valid
    (64, 128, True, False, False), (33, 200, True, True, True),
    (9, 130, True, False, False),           # C % 4 != 0: scalar path
])
def test_onebit_encode_ef_matches_plain(cuda, R, C, has_e, has_valid,
                                        symmetric):
    from repro_torch.kernels import onebit as K1
    gen = torch.Generator(device=cuda).manual_seed(R + C)
    g = _randn(gen, torch.float32, R, C)
    e = _randn(gen, torch.float32, R, C) if has_e else None
    valid = _randn(gen, torch.float32, R, C) > -0.5 if has_valid else None
    K1.reset_launches()
    kern = K1.encode_ef(g, e, valid, gain=2.0, symmetric=symmetric)
    plain = K1.onebit_encode_ef_ref(g, e, valid, gain=2.0,
                                    symmetric=symmetric)
    torch.cuda.synchronize()
    assert K1.LAUNCHES["onebit_encode_ef"] == 1
    assert torch.equal(kern[0], plain[0])
    scale = (g if e is None else g + 2.0 * e).abs().amax(-1, keepdim=True)
    for a, b in zip(kern[1:], plain[1:]):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert ((a - b).abs() / scale).max().item() <= ONEBIT_TOL


def test_attention_grad_matches_plain_gradients(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(gen, torch.float32, 2, 256, 32, 64)
    k, v = (_randn(gen, torch.float32, 2, 256, 4, 64) for _ in range(2))
    dout = _randn(gen, torch.float32, 2, 256, 32, 64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.reset_launches()
    out = FA.attention_grad(*leaves, window=64)
    out.backward(dout)
    assert FA.LAUNCHES["flash_attention"] == 1
    assert torch.equal(out, FA.attention(q, k, v, window=64))
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.attention_ref(*ref, window=64).backward(dout)
    for a, b in zip(leaves, ref):
        assert _err(a.grad, b.grad) <= 1e-5


def test_model_backward_through_kernel_path(cuda):
    """The flash kernel sits on the model's training forward on the card,
    and the attention projections still get their gradients (the kernel
    call is an autograd Function): within 1e-4 of the plain path's."""
    from repro_torch.data import LMDataConfig, make_lm_batches
    from repro_torch.train import value_and_grad
    cfg = get_config("tinyllama-1.1b").reduced(num_kv_heads=2)
    grads = []
    for c in (cfg, dataclasses.replace(cfg, attn_backend="ref")):
        model = build_model(c)
        params = model.init(seed=0, device=cuda)
        batch = make_lm_batches(LMDataConfig(vocab_size=c.vocab_size,
                                             seq_len=32, batch_size=2),
                                device=cuda)(0, 0)
        FA.reset_launches()
        _, g = value_and_grad(lambda p, b: model.loss_fn(
            p, b, compute_dtype=torch.float32))(params, batch)
        grads.append(g)
        assert FA.LAUNCHES["flash_attention"] == (
            cfg.num_layers if c is cfg else 0)
    for layer_k, layer_r in zip(grads[0]["layers"], grads[1]["layers"]):
        for name in ("wq", "wk", "wv"):
            gk = layer_k["mixer"][name]["w"]
            assert gk is not None and gk.abs().sum() > 0
            assert _err(gk, layer_r["mixer"][name]["w"]) <= 1e-4


@pytest.mark.parametrize("spec,wire", [("bsp/allreduce/none@8", 14700544),
                                       ("bsp/allreduce/onebit@8", 631744)])
def test_engine_on_card_bench_recipe(cuda, spec, wire):
    """The BENCH_pr10.json recipe through the kernels on the card: wire
    bytes and buckets exact (they do not depend on the init)."""
    from repro_torch.data import LMDataConfig, make_lm_batches
    from repro_torch.kernels import onebit as K1
    from repro_torch.train import Strategy, value_and_grad
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda)
    batches = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=16, batch_size=2),
                              device=cuda)
    engine = Strategy.parse(spec, lr=0.01, bucket_mb=0.25).build(
        value_and_grad(lambda p, b: model.loss_fn(
            p, b, compute_dtype=torch.float32)),
        layout=model.leaf_layout(params), device=cuda)
    K1.reset_launches()
    FA.reset_launches()
    _, hist, got = engine.run(params, batches, 2)
    assert got // 2 == wire
    assert engine.inner.modeled_timeline(params)["n_buckets"] == 7
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in hist)
    assert FA.LAUNCHES["flash_attention"] == cfg.num_layers * 8 * 2
    n_leaves = len(model.leaf_layout(params).names)
    assert K1.LAUNCHES["onebit_encode_ef"] == (
        n_leaves * 8 * 2 if spec.endswith("onebit@8") else 0)


# ------------------------------------------- dgc / terngrad / qsgd kernels
# Each kernel is elementwise given its per-segment scalars and its uniform
# draws, with the plain version's rounding (no contraction, IEEE
# division): planes and outputs must be equal exactly.
SEGMENT_CASES = [(1024, 256, 1), (1024, 256, 4), (37, 200, 1), (9, 130, 3),
                 (64, 256, 8)]


@pytest.mark.parametrize("R,C,S", SEGMENT_CASES)
def test_topk_compress_matches_plain(cuda, R, C, S):
    from repro_torch.kernels import topk as KK
    gen = torch.Generator(device=cuda).manual_seed(R + C + S)
    g = _randn(gen, torch.float32, R, C)
    e = _randn(gen, torch.float32, R, C)
    g[0, :5] = 0.0
    th = KK.threshold_for_density(g, e, 0.05, segments=S)
    KK.reset_launches()
    for ee, t in ((e, th), (None, th), (e, torch.zeros_like(th))):
        kern = KK.sparsify(g, ee, t)
        plain = KK.topk_ref(g, ee, t)
        assert all(torch.equal(a, b) for a, b in zip(kern, plain))
    torch.cuda.synchronize()
    assert KK.LAUNCHES["topk_compress"] == 3


@pytest.mark.parametrize("R,C,S", SEGMENT_CASES)
def test_terngrad_kernels_match_plain(cuda, R, C, S):
    from repro_torch.kernels import terngrad as KT
    gen = torch.Generator(device=cuda).manual_seed(R + C + S)
    g = _randn(gen, torch.float32, R, C)
    g[0, :5] = 0.0
    g[-1, 3] = 40.0
    u = torch.rand(R, C, generator=gen, device=cuda)
    s = g.reshape(S, -1).abs().amax(1) * 0.5          # clips some |p| > 1
    KT.reset_launches()
    assert torch.equal(KT.ternarize(g, u, s), KT.ternarize_ref(g, u, s))
    tern, scale = KT.compress(g, u, clip_sigma=2.5)
    rtern, rscale = KT.terngrad_ref(g, u, 2.5)
    torch.cuda.synchronize()
    assert torch.equal(tern, rtern) and torch.equal(scale, rscale)
    assert KT.LAUNCHES == {"terngrad_ternarize": 1, "terngrad_compress": 1}


@pytest.mark.parametrize("regime", ["outlier", "uniform", "clip0", "zero",
                                    "constant"])
def test_terngrad_compress_two_pass(cuda, regime):
    """terngrad_compress ternarizes against the provisional scale sigma
    and settles the scale on the device, ternarizing again where it is not
    sigma: a Gaussian with an outlier (max|g| >= sigma: the provisional
    plane stands), uniform +-1 (2.5 sigma ~ 1.44 > max|g|: the second
    pass), clip_sigma=0 (max|g| first) and all zeros give the plain
    version's plane and scale exactly.  A constant g has std exactly 0:
    the kernel follows JAX's Pallas kernel (no clip, s = max|g|), where
    terngrad_ref, as JAX's ref, clips everything to 0."""
    from repro_torch.kernels import terngrad as KT
    gen = torch.Generator(device=cuda).manual_seed(3)
    R, C = 4096, 256
    g = _randn(gen, torch.float32, R, C)
    g[0, :5] = 0.0
    if regime == "outlier":
        g[7, 9] = 40.0
    elif regime == "uniform":
        g = torch.rand(R, C, generator=gen, device=cuda) * 2 - 1
    elif regime == "zero":
        g = torch.zeros(R, C, device=cuda)
    elif regime == "constant":
        g = torch.full((R, C), 0.5, device=cuda)
    u = torch.rand(R, C, generator=gen, device=cuda)
    clip_sigma = 0.0 if regime == "clip0" else 2.5
    KT.reset_launches()
    tern, scale = KT.compress(g, u, clip_sigma=clip_sigma)
    torch.cuda.synchronize()
    if regime == "constant":
        amax = g.abs().amax()
        want = KT.ternarize_ref(g, u, amax), amax
    else:
        want = KT.terngrad_ref(g, u, clip_sigma)
    assert torch.equal(tern, want[0]) and torch.equal(scale, want[1])
    assert KT.LAUNCHES == {"terngrad_ternarize": 0, "terngrad_compress": 1}


@pytest.mark.parametrize("R,C,S", SEGMENT_CASES)
def test_qsgd_compress_matches_plain(cuda, R, C, S):
    from repro_torch.kernels import qsgd as KQ
    gen = torch.Generator(device=cuda).manual_seed(R + C + S)
    g = _randn(gen, torch.float32, R, C)
    g[0, :5] = 0.0
    u = torch.rand(R, C, generator=gen, device=cuda)
    KQ.reset_launches()
    for levels in (127, 15):
        q, norm = KQ.quantize(g, u, s_levels=levels, segments=S)
        rq, rnorm = KQ.qsgd_ref(g, u, levels, S)
        assert torch.equal(q, rq) and torch.equal(norm, rnorm)
    torch.cuda.synchronize()
    assert KQ.LAUNCHES["qsgd_compress"] == 2


def test_threshold_on_card_equals_cpu(cuda):
    """Order statistics and the fused interpolation are exact: the card
    and the CPU give the same threshold bit for bit."""
    from repro_torch.kernels import topk as KK
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = _randn(gen, torch.float32, 4, 300_001)
    for density in (0.01, 0.05, 0.5):
        card = KK.threshold_for_density(x, None, density, segments=4)
        cpu = KK.threshold_for_density(x.cpu(), None, density, segments=4)
        assert torch.equal(card.cpu(), cpu)


def test_measured_terngrad_step_kernel_equals_plain(cuda):
    """One ``bsp/ring/terngrad@4`` step with ``wire="measured"`` on the
    card, through the ternarize kernel and through the plain version,
    with the same generators and the plain attention on both: the planes
    are bitwise equal, so the parameters after the step are too."""
    from repro_torch.data import LMDataConfig, make_lm_batches
    from repro_torch.kernels import terngrad as KT
    from repro_torch.train import Strategy, value_and_grad
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              attn_backend="ref")
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda)
    batches = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=16, batch_size=2),
                              device=cuda)
    grad_fn = value_and_grad(lambda p, b: model.loss_fn(
        p, b, compute_dtype=torch.float32))
    out = {}
    for kb in ("auto", "ref"):
        KT.reset_launches()
        engine = Strategy.parse("bsp/ring/terngrad@4", lr=0.01,
                                bucket_mb=0.25, wire="measured",
                                kernel_backend=kb).build(
            grad_fn, layout=model.leaf_layout(params), device=cuda)
        out[kb] = engine.run(params, batches, 1)
        torch.cuda.synchronize()
        launched = KT.LAUNCHES["terngrad_ternarize"]
        assert (launched > 0) == (kb == "auto"), launched
    layout = model.leaf_layout(params)
    assert out["auto"][2] == out["ref"][2] > 0
    for a, b in zip(layout.leaves(out["auto"][0]),
                    layout.leaves(out["ref"][0])):
        assert torch.equal(a, b)


# ------------------------------------- segment scales across worker counts
def _phase26_chunks():
    """The ring chunk lengths of chip_smoke.py phase 26's @4 cells:
    full-width TinyLlama-1.1B at 2 layers, 4 MB buckets, 4 workers."""
    from repro_torch.comm.plan import CommPlan
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=2)
    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.float32, device="meta")
    return CommPlan.plan(model.leaf_layout(params).shapes(params),
                         n=4).chunk_lens()


@pytest.mark.parametrize("method", ["terngrad", "qsgd"])
def test_segment_scales_do_not_depend_on_worker_count(cuda, method):
    """A process holding one worker encodes its [1, L] segment; the
    logical axis encodes all four as [4, L].  Each segment's scale (and
    so every plane) must be the same bits either way, at phase 26's
    chunk lengths."""
    from repro_torch.comm.codecs import LANE, make_codec
    codec = make_codec(method)
    for L in _phase26_chunks():
        gen = torch.Generator(device=cuda).manual_seed(L)
        x = _randn(gen, torch.float32, 4, L)
        u = torch.rand((4, -(-L // LANE), LANE), generator=gen, device=cuda)
        both = codec.encode(x, u=u)
        for r in range(4):
            alone = codec.encode(x[r:r + 1], u=u[r:r + 1])
            for k, plane in both.items():
                assert torch.equal(alone[k][0], plane[r]), (L, r, k)


# ------------------------------------------------ onebit_compress and SSP
@pytest.mark.parametrize("R,C", [(4096, 200), (2048, 32000), (64, 256),
                                 (9, 130), (3, 1024)])
def test_onebit_compress_matches_plain(cuda, R, C):
    """Signs exactly equal (a block of exact zeros in c checks sign(0) =
    +1); scale and new_e within 2e-5 of the row's largest |c|."""
    from repro_torch.kernels import onebit as K1
    gen = torch.Generator(device=cuda).manual_seed(R + C)
    g = _randn(gen, torch.float32, R, C)
    e = 0.3 * _randn(gen, torch.float32, R, C)
    e[: max(1, R // 8), : C // 2] = -g[: max(1, R // 8), : C // 2]
    K1.reset_launches()
    kern = K1.compress(g, e)
    plain = K1.onebit_ref(g, e)
    torch.cuda.synchronize()
    assert K1.LAUNCHES["onebit_compress"] == 1
    assert kern[0].dtype == torch.int8 and kern[1].shape == (R, 1)
    assert torch.equal(kern[0], plain[0])
    assert (kern[0][0, : C // 2] == 1).all()
    scale = (g + e).abs().amax(-1, keepdim=True)
    for a, b in zip(kern[1:], plain[1:]):
        assert ((a - b).abs() / scale).max().item() <= ONEBIT_TOL


def test_ssp_ps_onebit_step_kernel_equals_plain(cuda):
    """One global step of ssp:3/ps/onebit@4 on reduced TinyLlama (5 push
    events): the kernel path (flash attention, onebit_encode_ef) against
    the plain path, per event: the same workers and staleness, losses
    within 1e-4."""
    from repro_torch.data import LMDataConfig, make_lm_batches
    from repro_torch.kernels import onebit as K1
    from repro_torch.train import Strategy, value_and_grad
    cfg = get_config("tinyllama-1.1b").reduced()
    hists = []
    for kernels in (True, False):
        c = cfg if kernels else dataclasses.replace(cfg, attn_backend="ref")
        model = build_model(c)
        params = model.init(seed=0, device=cuda)
        batches = make_lm_batches(LMDataConfig(vocab_size=c.vocab_size,
                                               seq_len=32, batch_size=2),
                                  device=cuda)
        strat = Strategy.parse("ssp:3/ps/onebit@4", lr=0.01,
                               kernel_backend="auto" if kernels else "ref")
        K1.reset_launches()
        FA.reset_launches()
        _, hist, _ = strat.build(value_and_grad(lambda p, b: model.loss_fn(
            p, b, compute_dtype=torch.float32)),
            layout=model.leaf_layout(params), device=cuda).run(
                params, batches, 1)
        n_leaves = len(model.leaf_layout(params).names)
        assert K1.LAUNCHES["onebit_encode_ef"] == (
            n_leaves * len(hist) if kernels else 0)
        assert FA.LAUNCHES["flash_attention"] == (
            cfg.num_layers * len(hist) if kernels else 0)
        hists.append(hist)
    kern, plain = hists
    assert [(h["worker"], h["max_staleness"]) for h in kern] == \
        [(h["worker"], h["max_staleness"]) for h in plain]
    assert len(kern) == 5
    assert max(abs(a["loss"] - b["loss"]) for a, b in zip(kern, plain)) \
        <= 1e-4


# ------------------------------------------------------- the Adam trainer
def test_launcher_adam_onebit_kernel_equals_plain(cuda):
    """The launcher's Adam + onebit run on reduced TinyLlama, 3 steps:
    the kernel path (flash attention, onebit_encode_ef) against the plain
    path (attn_backend and the compressor's backend "ref"): losses within
    1e-4, wire_bytes and lr equal."""
    from repro_torch.kernels import onebit as K1
    from repro_torch.launch import train as launcher
    args = launcher.parse_args(["--smoke", "--steps", "3", "--compress",
                                "onebit", "--device", "cuda"])
    hists = []
    for backend in ("auto", "ref"):
        K1.reset_launches()
        FA.reset_launches()
        _, hist = launcher.train(launcher.build(
            args, attn_backend=backend, kernel_backend=backend))
        on = backend == "auto"
        assert FA.LAUNCHES["flash_attention"] == (3 * 2 if on else 0)
        assert K1.LAUNCHES["onebit_encode_ef"] == (3 * 12 if on else 0)
        hists.append(hist)
    kern, plain = hists
    assert max(abs(a["loss"] - b["loss"]) for a, b in zip(kern, plain)) \
        <= 1e-4
    for key in ("wire_bytes", "lr"):
        assert [h[key] for h in kern] == [h[key] for h in plain]


def test_bf16_gradients_as_close_to_fp32_as_plain(cuda):
    """One batch's bf16-compute gradients on reduced TinyLlama, per JAX
    leaf: ||g_kernel,bf16 - g_fp32|| <= 1.25 ||g_plain,bf16 - g_fp32||
    (chip_smoke.py phase 11's rule)."""
    from repro_torch.data import LMDataConfig, make_lm_batches
    from repro_torch.train import value_and_grad
    cfg = get_config("tinyllama-1.1b").reduced()
    models = {b: build_model(dataclasses.replace(cfg, attn_backend=b))
              for b in ("auto", "ref")}
    params = models["auto"].init(seed=0, device=cuda)
    layout = models["auto"].leaf_layout(params)
    batch = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=64, batch_size=8),
                            device=cuda)(0, 0)

    def grads(backend, dtype):
        m = models[backend]
        _, g = value_and_grad(lambda p, b: m.loss_fn(
            p, b, compute_dtype=dtype))(params, batch)
        return list(layout.leaves(g))

    g32 = grads("ref", torch.float32)
    FA.reset_launches()
    kern = grads("auto", torch.bfloat16)
    assert FA.LAUNCHES["flash_attention"] == cfg.num_layers
    plain = grads("ref", torch.bfloat16)
    for name, k, p, r in zip(layout.names, kern, plain, g32):
        dk = torch.linalg.vector_norm(k - r).item()
        dp = torch.linalg.vector_norm(p - r).item()
        assert dk <= 1.25 * dp, (name, dk, dp)


def test_sharded_step_on_card_equals_cpu(cuda):
    """make_sharded_train_step over make_bucketed_allreduce at
    bsp/allreduce/onebit@2 (AdamW, reduced TinyLlama, 3 steps of batch 2 x
    seq 32 per worker) on the card (the kernels) against the same run on
    the CPU: losses within 1e-4, wire_bytes equal."""
    from repro_torch.core.compression import Compressor
    from repro_torch.core.precision import FP32
    from repro_torch.core.tree import tree_map
    from repro_torch.data import LMDataConfig, make_lm_batches
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import cosine_warmup
    from repro_torch.train import (TrainState, make_bucketed_allreduce,
                                   make_sharded_train_step, make_train_step,
                                   train_loop)
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    init = model.init(seed=0)                      # one init for both
    hists = []
    for device in (cuda, torch.device("cpu")):
        params = tree_map(lambda t: t.to(device), init)
        layout = model.leaf_layout(params)
        comp, opt = Compressor("onebit"), AdamW(0.01)
        step = make_train_step(
            model.loss_fn, opt, cosine_warmup(3e-3, 1, 3), precision=FP32,
            compressor=comp, layout=layout,
            reduce_fn=make_bucketed_allreduce(params, bucket_mb=0.25,
                                              layout=layout))
        state = TrainState.create(params, opt, comp, layout)
        state["ef"] = [torch.zeros((2,) + e.shape, device=device)
                       for e in state["ef"]]
        batches = make_lm_batches(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=32, batch_size=2),
            device=device)
        FA.reset_launches()
        _, hist = train_loop(
            make_sharded_train_step(step, 2, compressed=True), state,
            lambda t: tree_map(lambda *xs: torch.stack(xs),
                               *[batches(t, w) for w in range(2)]), 3,
            log_every=1)
        assert FA.LAUNCHES["flash_attention"] == (
            cfg.num_layers * 2 * 3 if device.type == "cuda" else 0)
        hists.append(hist)
    card, cpu = hists
    assert max(abs(a["loss"] - b["loss"]) for a, b in zip(card, cpu)) <= 1e-4
    assert [h["wire_bytes"] for h in card] == [h["wire_bytes"] for h in cpu]


# ------------------------------------------ checkpoints, generate, tracing
def test_checkpoint_bf16_cuda_round_trip(cuda, tmp_path):
    """A tree of bf16, fp32 and int32 CUDA tensors: saved (through the
    host), restored onto the card bitwise, directly and from an
    incremental save that links every shard."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": _randn(gen, torch.bfloat16, 300, 70),
            "layers": [{"b": _randn(gen, torch.float32, 70)},
                       {"b": _randn(gen, torch.bfloat16, 70)}],
            "ids": torch.arange(-5, 45, device=cuda, dtype=torch.int32)}
    base, nxt = str(tmp_path / "a"), str(tmp_path / "b")
    m1 = save_checkpoint(base, tree, step=3, shard_bytes=20_000,
                         hash_leaves=True)
    m2 = save_checkpoint(nxt, tree, step=4, shard_bytes=20_000,
                         incremental_from=base)
    assert m1["shards"] > 1 and m2["linked_shards"] == m2["shards"]
    assert [r["dtype"] for r in m1["leaves"]] == \
        ["int32", "float32", "bfloat16", "bfloat16"]
    for path, step in ((base, 3), (nxt, 4)):
        got, s = load_checkpoint(path, tree)
        assert s == step
        for a, b in ((got["w"], tree["w"]), (got["ids"], tree["ids"]),
                     (got["layers"][0]["b"], tree["layers"][0]["b"]),
                     (got["layers"][1]["b"], tree["layers"][1]["b"])):
            assert a.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a.view(torch.int16) if a.dtype ==
                               torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype ==
                               torch.bfloat16 else b)


def test_generate_on_cuda(cuda):
    """generate on the card (flash prefill and decode) gives the greedy
    tokens of the same run on the CPU (plain path), reduced TinyLlama,
    fp32; one prefill and one decode launch per layer and step."""
    from repro_torch.core.tree import tree_map
    from repro_torch.serve import generate
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda)
    prompt = torch.randint(1, cfg.vocab_size, (3, 7),
                           generator=torch.Generator().manual_seed(1))
    FA.reset_launches()
    out = generate(model, params, prompt, 10)
    torch.cuda.synchronize()
    assert out.device.type == "cuda" and out.shape == (3, 17)
    assert FA.LAUNCHES["flash_attention"] == cfg.num_layers
    assert FA.LAUNCHES["flash_decode"] == 9 * cfg.num_layers
    ref = generate(model, tree_map(lambda t: t.cpu(), params), prompt, 10,
                   device="cpu")
    assert torch.equal(out.cpu(), ref)


# ------------------------------------------------------- elastic training
def _elastic_engine(cuda, spec):
    from repro_torch.train import Strategy, value_and_grad
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda)
    grad_fn = value_and_grad(
        lambda p, b: model.loss_fn(p, b, compute_dtype=torch.float32))
    eng = Strategy.parse(spec, lr=0.01, bucket_mb=0.25).build(
        grad_fn, layout=model.leaf_layout(params), device=cuda)
    from repro_torch.data import LMDataConfig, make_lm_batches
    batches = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=32, batch_size=2),
                              device=cuda)
    return eng, params, batches


def test_device_reshard_keeps_survivor_ef_on_card(cuda):
    """bsp+backup:1/allreduce/onebit@4 on the card (the kernels): a
    dropped worker's EF is bitwise unchanged by its step, and a reshard
    that loses worker 1 and grows back to 4 keeps the survivors' EF
    tensors (the same tensors, bitwise) and gives the grown slot zeros."""
    from repro_torch.kernels import onebit as K1
    eng, params, batches = _elastic_engine(
        cuda, "bsp+backup:1/allreduce/onebit@4")
    st = eng.init(params)
    K1.reset_launches()
    st, _ = eng.step(st, batches, 0)
    assert K1.LAUNCHES["onebit_encode_ef"] > 0
    dropped = [x.clone() for x in st["ef"][3]]
    st, (ev,) = eng.step(st, batches, 1)
    assert ev["dropped"] == [3]
    assert all(torch.equal(a, b) for a, b in zip(st["ef"][3], dropped))
    rows = [list(r) for r in st["ef"]]
    clones = [[x.clone() for x in r] for r in st["ef"]]
    st = eng.reshard(st, 4, step=2, lost=(1,))
    for slot, old in zip((0, 1, 2), (0, 2, 3)):
        assert all(a is b and torch.equal(a, c) for a, b, c in
                   zip(st["ef"][slot], rows[old], clones[old]))
    assert all(x.device.type == "cuda" and not x.any() for x in st["ef"][3])
    st, (ev,) = eng.step(st, batches, 2)
    assert torch.isfinite(torch.tensor(ev["loss"]))


def test_background_save_survives_inplace_step_on_card(cuda, tmp_path):
    """export_state -> save_engine_state(background=True) -> a step and an
    in-place update of every exported tensor -> join -> restore gives the
    pre-step state bitwise: the device->host copy is taken before the
    write thread starts."""
    from repro_torch.core.tree import get_path, leaf_paths, tree_map
    from repro_torch.elastic import restore_engine_state, save_engine_state
    eng, params, batches = _elastic_engine(cuda, "bsp/allreduce/onebit@2")
    st = eng.init(params)
    st, _ = eng.step(st, batches, 0)
    arrays, _ = eng.export_state(st)
    want = tree_map(lambda x: x.clone(), arrays)
    th = save_engine_state(str(tmp_path / "ck"), eng, st, 1,
                           background=True)
    st, _ = eng.step(st, batches, 1)
    for path in leaf_paths(arrays):
        get_path(arrays, path).mul_(-3.0).add_(1.0)
    th.join(timeout=300)
    assert not th.is_alive()
    eng2, _, _ = _elastic_engine(cuda, "bsp/allreduce/onebit@2")
    got, meta = restore_engine_state(str(tmp_path / "ck"), eng2, params)
    assert meta["step"] == 1
    got_arrays, _ = eng2.export_state(got)
    assert leaf_paths(got_arrays) == leaf_paths(want)
    for path in leaf_paths(want):
        a, b = get_path(got_arrays, path), get_path(want, path)
        assert a.device.type == "cuda" and torch.equal(a, b)


# ----------------------------------------------------- the hybrid engine
def _tiny_hybrid(dev, rows=8, d=8, f=16):
    """The hybrid acceptance model (2 stacked blocks) and 4 steps x 4
    data slots of batches on ``dev``, drawn on the CPU."""
    from repro_torch.parallel import make_tiny_transformer
    params, model = make_tiny_transformer(2, d, f, seed=0, device=dev)
    gen = torch.Generator().manual_seed(1)
    w_t = torch.randn(d, d, generator=gen)
    xs = {(t, w): torch.randn(rows, d, generator=gen)
          for t in range(4) for w in range(4)}

    def batches(t, w):
        return {"x": xs[t, w].to(dev), "y": torch.tanh(xs[t, w] @ w_t).to(
            dev)}
    return params, model, batches


@pytest.mark.parametrize("spec", ["bsp/ring/none@8:d2.t2.s2",
                                  "bsp/ring/none@8:d2.t2.s2.m4.1f1b.v1",
                                  "bsp/ps/onebit@8:d2.t2.s2.z3.adamw"])
def test_hybrid_mesh_on_card_equals_cpu(cuda, spec):
    """A d2.t2.s2 mesh at the tiny size (GPipe, 1F1B, onebit ZeRO-3
    AdamW): the card's losses and parameters within 1e-5 of the CPU
    run's, wire bytes equal."""
    from repro_torch.train import Strategy
    runs = []
    for dev in (cuda, torch.device("cpu")):
        params, model, batches = _tiny_hybrid(dev)
        p, hist, wire = Strategy.parse(spec, lr=0.05, bucket_mb=1e-4).build(
            model, device=dev).run(params, batches, 4)
        runs.append((p, [h["loss"] for h in hist], wire))
    (pg, lg, wg), (pc, lc, wc) = runs
    assert wg == wc
    assert max(abs(a - b) for a, b in zip(lg, lc)) <= 1e-5
    assert max(_err(pg[k].cpu(), pc[k]) for k in pc) <= 1e-5


def test_zero3_equals_zero1_on_card(cuda):
    """ZeRO-1 and ZeRO-3 AdamW on 4 data slots, on the card: the same
    losses (both reduces sum the slots in one order) and parameters, and
    ZeRO-3's per-device parameter bytes a quarter of ZeRO-1's."""
    from repro_torch.train import Strategy
    params, model, batches = _tiny_hybrid(cuda, rows=16, d=32, f=64)
    runs = []
    for spec in ("bsp/ps/none@4:d4.z1.adamw", "bsp/ps/none@4:d4.z3.adamw"):
        eng = Strategy.parse(spec, lr=0.01, bucket_mb=1e-3).build(
            model, device=cuda)
        st = eng.init(params)
        for t in range(4):
            st, (ev,) = eng.step(st, batches, t)
            runs.append(ev["loss"])
        runs.append(eng.inner.per_device_state_bytes(st))
        runs.append(eng.finalize(st))
    l1, b1, p1, l3, b3, p3 = runs[:4], runs[4], runs[5], runs[6:10], \
        runs[10], runs[11]
    assert max(abs(a - b) for a, b in zip(l1, l3)) <= 1e-6
    assert max(_err(p1[k], p3[k]) for k in p1) <= 1e-6
    assert b1["params"] == 4 * b3["params"] and b1["opt"] == b3["opt"]


def test_hybrid_tinyllama_step_launches_kernels(cuda):
    """bsp/ps/onebit@4:d4.z3.adamw on TinyLlama at full width and 2
    layers, one step: the kernel path launches flash_attention once per
    layer and data slot and onebit_encode_ef once per leaf and data slot
    (the launch counters chip_smoke.py reads); the plain path launches
    none, and the losses agree within 1e-4."""
    from repro_torch.data import LMDataConfig, make_lm_batches
    from repro_torch.kernels import onebit as K1
    from repro_torch.train import Strategy, value_and_grad
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=2)
    losses = []
    for kernels in (True, False):
        c = cfg if kernels else dataclasses.replace(cfg, attn_backend="ref")
        model = build_model(c)
        params = model.init(seed=0, device=cuda)
        layout = model.leaf_layout(params)
        batches = make_lm_batches(LMDataConfig(
            vocab_size=c.vocab_size, seq_len=128, batch_size=2), device=cuda)
        strat = Strategy.parse("bsp/ps/onebit@4:d4.z3.adamw", lr=1e-4,
                               kernel_backend="auto" if kernels else "ref")
        K1.reset_launches()
        FA.reset_launches()
        _, hist, _ = strat.build(value_and_grad(lambda p, b: model.loss_fn(
            p, b, compute_dtype=torch.float32)), layout=layout,
            device=cuda).run(params, batches, 1)
        assert FA.LAUNCHES["flash_attention"] == (
            cfg.num_layers * 4 if kernels else 0)
        assert K1.LAUNCHES["onebit_encode_ef"] == (
            len(layout.names) * 4 if kernels else 0)
        losses.append(hist[0]["loss"])
        del model, params
        torch.cuda.empty_cache()
    assert all(torch.isfinite(torch.tensor(losses)))
    assert abs(losses[0] - losses[1]) <= 1e-4


# ------------------------------------ tp decode and the model families
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd", [(28, 4, 128), (16, 2, 64)])
def test_flash_kernels_at_family_shapes(cuda, dtype, H, KV, hd):
    """Qwen2-VL-7B's attention (group 7, head_dim 128) and one tp=2 rank
    of TinyLlama's (16 heads on 2 KV heads, its cache a contiguous block
    of a rank-major [2, B, L, KV, hd] tensor) against the plain
    versions."""
    gen = torch.Generator(device=cuda).manual_seed(H + hd)
    B, S, L = 2, 200, 300
    q = _randn(gen, dtype, B, S, H, hd)
    k, v = _randn(gen, dtype, B, S, KV, hd), _randn(gen, dtype, B, S, KV, hd)
    assert _err(FA.attention(q, k, v), FA.attention_ref(q, k, v)) <= \
        TOLS[dtype]
    qd = _randn(gen, dtype, B, 1, H, hd)
    ck, cv = (_randn(gen, dtype, 2, B, L, KV, hd)[1] for _ in range(2))
    pos = torch.tensor([17, L - 1], device=cuda)
    assert _err(FA.decode(qd, ck, cv, pos), FA.decode_ref(qd, ck, cv, pos)) \
        <= TOLS[dtype]


def test_tp2_decode_on_card_matches_tp1(cuda):
    """Reduced TinyLlama in fp32: the tp=2 step (two logical ranks, each
    launching flash_decode on its heads) gives tp=1's logits within 1e-5
    and the same greedy stream through the engine."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request
    from repro_torch.serve.tp import TPContext
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda)
    toks = torch.randint(1, cfg.vocab_size, (3, 12), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))
    outs = []
    for tp in (1, 2):
        _, st = model.prefill(params, toks[:, :8], compute_dtype=torch.float32)
        caches = model.cache_from_prefill(st, 16, dtype=torch.float32)
        p_, cfg_, kw = params, cfg, {}
        if tp > 1:
            ctx = TPContext(cfg, tp)
            p_, cfg_ = ctx.shard_params(params), ctx.cfg_local
            caches, kw = ctx.shard_cache(caches), dict(tp_axis="model")
        FA.reset_launches()
        seq = []
        for t in range(8, 12):
            lg, caches = T.decode_step(p_, cfg_, caches, toks[:, t:t + 1],
                                       torch.full((3,), t, device=cuda),
                                       compute_dtype=torch.float32, **kw)
            seq.append(lg)
        torch.cuda.synchronize()
        assert FA.LAUNCHES["flash_decode"] == 4 * tp * cfg.num_layers
        outs.append(torch.cat(seq, 1))
    assert _err(outs[0], outs[1]) <= 1e-5
    streams = []
    for tp in (1, 2):
        reqs = [Request(rid=i, prompt=toks[i, :5].tolist(), max_new_tokens=6)
                for i in range(3)]
        ServeEngine(model, params, ServeConfig(slots=2, max_len=16,
                                               page_size=4, tp=tp),
                    device=cuda).run(reqs)
        streams.append([r.output for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "stablelm-1.6b",
                                  "deepseek-v2-lite-16b"])
def test_family_on_card_matches_cpu(cuda, arch):
    """Reduced configs in fp32: the card's forward (the flash kernel for
    GQA; MLA and MoE are plain) equals the CPU's within 1e-4, and the
    engine's greedy streams on the card (paged) equal the CPU's."""
    from repro_torch.core.tree import tree_map
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    cpu_params = model.init(seed=0)
    params = tree_map(lambda t: t.to(cuda), cpu_params)
    toks = torch.randint(1, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(3))
    FA.reset_launches()
    out, _, _ = model.forward(params, toks.to(cuda),
                              compute_dtype=torch.float32)
    ref, _, _ = model.forward(cpu_params, toks, compute_dtype=torch.float32)
    assert _err(out.cpu(), ref) <= 1e-4
    assert FA.LAUNCHES["flash_attention"] == (
        0 if cfg.attn_type == "mla" else cfg.num_layers)
    streams = []
    for dev, p in ((cuda, params), ("cpu", cpu_params)):
        reqs = [Request(rid=i, prompt=toks[i, :5].tolist(), max_new_tokens=6)
                for i in range(2)]
        ServeEngine(model, p, ServeConfig(slots=2, max_len=16, page_size=4),
                    device=dev).run(reqs)
        streams.append([r.output for r in reqs])
    assert streams[0] == streams[1]


# ---------------------------------- the recurrent and encoder-decoder families
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_griffin_and_whisper_shapes(cuda, dtype):
    """RecurrentGemma-9B's local attention (16 query heads on one KV head,
    head_dim 256, window 2048): prefill past the window (S 2560 in bf16,
    700 in fp32) and the ring decode with slots at positions 100-3000;
    Whisper's encoder (20 heads, hd 64, non-causal at S 1500, not a tile
    multiple) against the plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(256)
    S = 2560 if dtype == torch.bfloat16 else 700
    q = _randn(gen, dtype, 1, S, 16, 256)
    k, v = _randn(gen, dtype, 1, S, 1, 256), _randn(gen, dtype, 1, S, 1, 256)
    for window in (2048, 128, 0):
        out = FA.attention(q, k, v, window=window)
        assert _err(out, FA.attention_ref(q, k, v, window=window)) <= \
            TOLS[dtype], window
    qd = _randn(gen, dtype, 8, 1, 16, 256)
    ck, cv = (_randn(gen, dtype, 8, 2048, 1, 256) for _ in range(2))
    pos = torch.tensor([100, 900, 2046, 2047, 2048, 2049, 2500, 3000],
                       device=cuda)
    out = FA.decode(qd, ck, cv, pos, window=2048)
    assert torch.isfinite(out).all()
    assert _err(out, FA.decode_ref(qd, ck, cv, pos, window=2048)) <= \
        TOLS[dtype]
    q, k, v = (_randn(gen, dtype, 4, 1500, 20, 64) for _ in range(3))
    assert _err(FA.attention(q, k, v, causal=False),
                FA.attention_ref(q, k, v, causal=False)) <= TOLS[dtype]


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_recurrent_family_on_card_matches_cpu(cuda, arch):
    """RecurrentGemma (rglru, rglru, local at head_dim 256, window 16) and
    RWKV-6, reduced, fp32: the card's forward equals the CPU's within
    1e-4 (the local layer through flash_attention), and the engine's
    greedy streams on the card (prompts past the window, paged) equal the
    CPU's, the local layer's decode through flash_decode."""
    from repro_torch.core.tree import tree_map
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request
    cfg = get_config(arch).reduced(num_layers=3)
    if arch == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, head_dim=256, window=16)
    local = cfg.layer_kinds.count("local")
    model = build_model(cfg)
    cpu_params = model.init(seed=0)
    params = tree_map(lambda t: t.to(cuda), cpu_params)
    toks = torch.randint(1, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(4))
    FA.reset_launches()
    out, _, _ = model.forward(params, toks.to(cuda),
                              compute_dtype=torch.float32)
    ref, _, _ = model.forward(cpu_params, toks, compute_dtype=torch.float32)
    assert _err(out.cpu(), ref) <= 1e-4
    assert FA.LAUNCHES["flash_attention"] == local
    streams = []
    for dev, p in ((cuda, params), ("cpu", cpu_params)):
        reqs = [Request(rid=i, prompt=toks[i, :20].tolist(),
                        max_new_tokens=6) for i in range(2)]
        FA.reset_launches()
        m = ServeEngine(model, p, ServeConfig(slots=2, max_len=32,
                                              page_size=4),
                        device=dev).run(reqs)
        if dev == cuda:
            assert FA.LAUNCHES["flash_decode"] == \
                m["decode_iterations"] * local
        streams.append([r.output for r in reqs])
    assert streams[0] == streams[1]


def test_whisper_on_card_matches_cpu(cuda):
    """Reduced Whisper in fp32: encoder (non-causal flash_attention),
    teacher-forced decoder and greedy decode_step (flash_decode on the
    self-attention cache, plain cross-attention) on the card equal the
    CPU's."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import whisper as W
    cfg = get_config("whisper-large-v3").reduced()
    model = build_model(cfg)
    cpu_params = model.init(seed=0)
    params = tree_map(lambda t: t.to(cuda), cpu_params)
    gen = torch.Generator().manual_seed(5)
    frames = torch.randn(2, cfg.max_source_positions, cfg.d_model,
                         generator=gen)
    toks = torch.randint(1, cfg.vocab_size, (2, 8), generator=gen)
    outs = []
    for dev, p in ((cuda, params), ("cpu", cpu_params)):
        FA.reset_launches()
        enc = W.encode(p, cfg, frames.to(dev), compute_dtype=torch.float32)
        logits = W.decode_train(p, cfg, toks.to(dev), enc,
                                compute_dtype=torch.float32)
        cache = model.init_cache(2, 8, dtype=torch.float32,
                                 enc_frames=cfg.max_source_positions,
                                 device=dev)
        cache["cross"] = W.build_cross_cache(p, cfg, enc,
                                             dtype=torch.float32)
        tok, seq = toks[:, :1].to(dev), []
        for t in range(8):
            lg, cache = model.decode_step(p, cache, tok,
                                          torch.full((2,), t, device=dev),
                                          compute_dtype=torch.float32)
            tok = lg[..., :cfg.vocab_size].argmax(-1)
            seq.append(tok[:, 0].tolist())
        if dev == cuda:
            torch.cuda.synchronize()
            assert FA.LAUNCHES["flash_attention"] == \
                cfg.encoder_layers + cfg.num_layers
            assert FA.LAUNCHES["flash_decode"] == 8 * cfg.num_layers
        outs.append((enc.cpu(), logits.cpu(), seq))
    assert _err(outs[0][0], outs[1][0]) <= 1e-4
    assert _err(outs[0][1], outs[1][1]) <= 1e-4
    assert outs[0][2] == outs[1][2]


# ------------------------------------------- the dry-run's lengths (25d)
# Outputs at these lengths are small (std about sqrt(e / keys)), so each
# query row or slot is held to its own scale: max |kernel - plain| within
# REL[dtype] of its max |plain|.  The plain version with DROP keys (one
# K/V tile of the bf16 prefill) masked out must miss that bound in every
# row, so a kernel that loses a tile fails.
REL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
DROP = 64


def _row_rel(a, b, dim):
    """Per slice of ``dim``: max |a - b| over the slice's max |b|."""
    a = a.float().movedim(dim, 0).flatten(1)
    b = b.float().movedim(dim, 0).flatten(1)
    return (a - b).abs().amax(1) / b.abs().amax(1)


def test_flash_prefill_last_rows_at_32k(cuda):
    """The bf16 prefill at S=32768 (TinyLlama's heads, causal): its last
    256 query rows against plain fp32 attention of those rows over all
    keys (the whole plain product does not fit)."""
    gen = torch.Generator(device=cuda).manual_seed(32)
    S, R, H, KV, hd = 32768, 256, 32, 4, 64
    q = _randn(gen, torch.bfloat16, 1, S, H, hd)
    k, v = (_randn(gen, torch.bfloat16, 1, S, KV, hd) for _ in range(2))
    out = FA.attention(q, k, v, causal=True)[:, S - R:]
    kr = k.float().repeat_interleave(H // KV, dim=2)
    vr = v.float().repeat_interleave(H // KV, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q[:, S - R:].float(), kr) / hd ** 0.5
    qi = torch.arange(S - R, S, device=cuda)[:, None]
    kj = torch.arange(S, device=cuda)[None]
    sc = sc.masked_fill(kj > qi, float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vr)
    dropped = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc.masked_fill(
        (kj >= S // 2) & (kj < S // 2 + DROP), float("-inf")), -1), vr)
    assert _err(out, ref) <= TOLS[torch.bfloat16]
    assert _row_rel(out, ref, 1).max() <= REL[torch.bfloat16] \
        < _row_rel(dropped, ref, 1).min()


def _decode_checks(q, ck, cv, pos, window, dtype):
    """The kernel against decode_ref, and decode_ref without cache rows
    [0, DROP) (the rest as a plain cache; a ring's slots are all written
    at the positions used here) against decode_ref."""
    ref = FA.decode_ref(q, ck, cv, pos, window=window)
    out = FA.decode(q, ck, cv, pos, window=window)
    L = ck.shape[1]
    dropped = FA.decode_ref(q, ck[:, DROP:], cv[:, DROP:],
                            torch.full_like(pos, L - DROP - 1) if window
                            else pos - DROP)
    assert _err(out, ref) <= TOLS[dtype]
    assert _row_rel(out, ref, 0).max() <= REL[dtype] \
        < _row_rel(dropped, ref, 0).min()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_32k(cuda, dtype):
    """8 slots on a 32768-row cache, positions at split-K chunk edges."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        decode_chunk
    gen = torch.Generator(device=cuda).manual_seed(33)
    B, L, H, KV, hd = 8, 32768, 32, 4, 64
    c = decode_chunk(B, L, KV)
    pos = torch.tensor([L - 1, L - 2, c - 1, c, 2 * c, L - c, L - c - 1,
                        20000], device=cuda)
    q = _randn(gen, dtype, B, 1, H, hd)
    ck, cv = (_randn(gen, dtype, B, L, KV, hd) for _ in range(2))
    _decode_checks(q, ck, cv, pos, 0, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd,window", [(32, 4, 64, 4096),
                                            (16, 1, 256, 2048)])
def test_flash_ring_decode_at_524287(cuda, dtype, H, KV, hd, window):
    """The long_500k rings: a 4096-row SWA ring (hd 64) and
    RecurrentGemma's 2048-row ring (hd 256) read at positions up to
    524287."""
    gen = torch.Generator(device=cuda).manual_seed(hd)
    B = 8
    pos = torch.tensor([524287 - i * (window + 3) for i in range(B)],
                       device=cuda)
    q = _randn(gen, dtype, B, 1, H, hd)
    ck, cv = (_randn(gen, dtype, B, window, KV, hd) for _ in range(2))
    _decode_checks(q, ck, cv, pos, window, dtype)
