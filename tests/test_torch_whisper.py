"""Whisper's encoder-decoder in the port against the JAX package's, at
``.reduced()`` (2 + 2 layers, 16 frames) in fp32 on the CPU, with the JAX
weights carried over by ``from_jax_params`` and the same seeded frames
and tokens.

Tolerances: encoder outputs and logits within 1e-5, losses within 1e-4;
every gradient leaf within 2e-5 of its largest |g| (the key biases, whose
gradient is zero in exact arithmetic, within 2e-5 of the tree's largest
|g| on both sides); decode through the
caches against teacher forcing < 2e-4 (tests/test_decode_equivalence.py);
greedy tokens exactly equal.  The launcher case runs ``launch/train.py``
on the reduced config against the reference launcher's body fed the same
batches (the frame stub is drawn from a ``torch.Generator`` in the port
and from ``jax.random`` in the reference).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.compression import Compressor as JaxCompressor
from repro.core.precision import PrecisionPolicy as JaxPrecisionPolicy
from repro.models import build_model as jax_build_model
from repro.models import whisper as jax_W
from repro.optim import OPTIMIZERS as JAX_OPTIMIZERS
from repro.optim.schedule import cosine_warmup as jax_cosine_warmup
from repro.train.train_loop import TrainState as JaxTrainState
from repro.train.train_loop import make_train_step as jax_make_train_step
from repro.train.train_loop import train_loop as jax_train_loop
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as launcher
from repro_torch.models import build_model
from repro_torch.models import whisper as W
from repro_torch.train.train_loop import _loss_and_grads

torch.set_num_threads(2)

ARCH = "whisper-large-v3"
TOL, LOSS_TOL, GRAD_TOL, DECODE_TOL = 1e-5, 1e-4, 2e-5, 2e-4
B, S = 2, 10
_CACHE = {}


def setup():
    if not _CACHE:
        jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        _CACHE.update(jcfg=jcfg, jmodel=jmodel, jparams=jparams, cfg=cfg,
                      model=build_model(cfg),
                      params=W.from_jax_params(
                          cfg, jax.tree.map(np.array, jparams)))
    return _CACHE


def _inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    frames = rng.randn(B, cfg.max_source_positions,
                       cfg.d_model).astype(np.float32)
    toks = rng.randint(0, cfg.vocab_size, (B, S + 1))
    return frames, toks


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.detach().numpy())))


def test_build_model_has_no_decoder_only_entries():
    s = setup()
    m = s["model"]
    assert m.forward is None and m.prefill is None
    assert m.cache_from_prefill is None
    jm = s["jmodel"]
    assert jm.forward is None and jm.prefill is None


def test_init_matches_jax_shapes_and_dtypes():
    """The seeded bf16 init has the JAX init's leaves (names, shapes,
    dtypes; norms in fp32), and ``leaf_layout`` names them in
    ``jax.tree.leaves`` order."""
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    p = model.init(seed=0, dtype=torch.bfloat16, vocab_pad_multiple=8)
    jp = jax.eval_shape(lambda: jax_build_model(
        jax_get_config(ARCH).reduced()).init(
            jax.random.PRNGKey(0), dtype=jnp.bfloat16, vocab_pad_multiple=8))
    layout = model.leaf_layout(p)
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    names = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in jleaves]
    assert tuple(names) == layout.names
    assert [tuple(x.shape) for _, x in jleaves] == layout.shapes(p)
    for i, (_, x) in enumerate(jleaves):
        assert str(layout.leaf(p, i).dtype)[6:] == str(x.dtype), names[i]
    assert tuple(p["dec_pos"].shape) == (448, cfg.d_model)


def test_sinusoids_match_jax():
    for length, ch in ((16, 128), (1500, 1280)):
        assert _err(jax_W._sinusoids(length, ch), W._sinusoids(length, ch)) \
            == 0.0


def test_encode_decode_train_loss_and_grads_match_jax():
    s = setup()
    cfg = s["cfg"]
    frames, toks = _inputs(cfg)
    jenc = jax_W.encode(s["jparams"], s["jcfg"], jnp.asarray(frames),
                        compute_dtype=jnp.float32)
    enc = W.encode(s["params"], cfg, torch.from_numpy(frames),
                   compute_dtype=torch.float32)
    assert _err(jenc, enc) <= TOL
    jlog = jax_W.decode_train(s["jparams"], s["jcfg"],
                              jnp.asarray(toks[:, :-1]), jenc,
                              compute_dtype=jnp.float32)
    log = W.decode_train(s["params"], cfg, torch.from_numpy(toks[:, :-1]),
                         enc, compute_dtype=torch.float32)
    assert _err(jlog, log) <= TOL
    batch = {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: s["jmodel"].loss_fn(p, jb, compute_dtype=jnp.float32),
        has_aux=True))(s["jparams"])
    loss, mets, grads = _loss_and_grads(
        lambda p, b: s["model"].loss_fn(p, b, compute_dtype=torch.float32),
        s["params"], tb)
    assert abs(float(jl) - float(loss)) <= LOSS_TOL
    assert float(mets["aux"]) == float(jm["aux"]) == 0.0
    layout = s["model"].leaf_layout(s["params"])
    jleaves = [np.asarray(g) for g in jax.tree.leaves(jg)]
    top = max(float(np.abs(g).max()) for g in jleaves)
    for i, jgl in enumerate(jleaves):
        name, g = layout.names[i], layout.leaf(grads, i)
        if name.endswith("attn/wk/b"):
            # zero in exact arithmetic (softmax ignores a shift common to
            # every key): both sides are rounding, far below the tree's |g|
            assert max(float(np.abs(jgl).max()),
                       float(g.abs().max())) <= GRAD_TOL * top, name
            continue
        scale = max(float(np.abs(jgl).max()), 1e-12)
        assert _err(jgl, g) <= GRAD_TOL * scale, name


def test_cross_cache_and_decode_match_teacher_forcing_and_jax():
    """tests/test_decode_equivalence.py's Whisper case on the port, and
    each step's logits against the JAX decode's."""
    s = setup()
    cfg = s["cfg"]
    frames, toks = _inputs(cfg, seed=1)
    toks = toks[:, :S]
    enc = W.encode(s["params"], cfg, torch.from_numpy(frames),
                   compute_dtype=torch.float32)
    full = W.decode_train(s["params"], cfg, torch.from_numpy(toks), enc,
                          compute_dtype=torch.float32)
    jenc = jax_W.encode(s["jparams"], s["jcfg"], jnp.asarray(frames),
                        compute_dtype=jnp.float32)
    caches = s["model"].init_cache(B, S, dtype=torch.float32)
    jcaches = s["jmodel"].init_cache(B, S, dtype=jnp.float32)
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in caches.items()} == \
        {k: {n: t.shape for n, t in v.items()} for k, v in jcaches.items()}
    caches["cross"] = W.build_cross_cache(s["params"], cfg, enc,
                                          dtype=torch.float32)
    jcaches["cross"] = jax_W.build_cross_cache(s["jparams"], s["jcfg"],
                                               jenc, dtype=jnp.float32)
    assert _err(jcaches["cross"]["k"], caches["cross"]["k"]) <= TOL
    outs = []
    for t in range(S):
        lg, caches = s["model"].decode_step(
            s["params"], caches, torch.from_numpy(toks[:, t:t + 1]),
            torch.full((B,), t), compute_dtype=torch.float32)
        jlg, jcaches = s["jmodel"].decode_step(
            s["jparams"], jcaches, jnp.asarray(toks[:, t:t + 1]), t,
            compute_dtype=jnp.float32)
        assert _err(jlg, lg) <= DECODE_TOL, t
        outs.append(lg[:, 0])
    assert float((full - torch.stack(outs, 1)).abs().max()) < DECODE_TOL
    assert _err(jcaches["self"]["k"], caches["self"]["k"]) <= DECODE_TOL


def test_greedy_decode_tokens_equal_jax():
    """Greedy decoding of 12 tokens from a start token: the port's tokens
    equal the JAX package's bit for bit; rows at their own positions."""
    s = setup()
    cfg = s["cfg"]
    frames, _ = _inputs(cfg, seed=2)
    n = 12
    enc = W.encode(s["params"], cfg, torch.from_numpy(frames),
                   compute_dtype=torch.float32)
    caches = s["model"].init_cache(B, n, dtype=torch.float32)
    caches["cross"] = W.build_cross_cache(s["params"], cfg, enc,
                                          dtype=torch.float32)
    jenc = jax_W.encode(s["jparams"], s["jcfg"], jnp.asarray(frames),
                        compute_dtype=jnp.float32)
    jcaches = s["jmodel"].init_cache(B, n, dtype=jnp.float32)
    jcaches["cross"] = jax_W.build_cross_cache(s["jparams"], s["jcfg"], jenc,
                                               dtype=jnp.float32)
    tok = torch.ones((B, 1), dtype=torch.long)
    jtok = jnp.ones((B, 1), jnp.int32)
    got, want = [], []
    for t in range(n):
        lg, caches = s["model"].decode_step(s["params"], caches, tok,
                                            torch.full((B,), t),
                                            compute_dtype=torch.float32)
        jlg, jcaches = s["jmodel"].decode_step(s["jparams"], jcaches, jtok, t,
                                               compute_dtype=jnp.float32)
        tok = lg[..., :cfg.vocab_size].argmax(-1)
        jtok = jnp.argmax(jlg[..., :cfg.vocab_size], -1)
        got.append(tok[:, 0].tolist())
        want.append(np.asarray(jtok[:, 0]).tolist())
    assert got == want


def test_decoder_positions_clip_at_447():
    """Positions past the 448-row table read row 447, as the reference's
    ``jnp.clip`` does."""
    s = setup()
    p = s["params"]
    pos = torch.tensor([0, 447, 448, 900])
    rows = W._dec_positions(p, pos, torch.float32)
    assert torch.equal(rows, p["dec_pos"][[0, 447, 447, 447]])
    jrows = jax_W._dec_positions(s["jparams"], 450, 1, 1, jnp.float32)
    assert _err(jrows[0, 0], rows[3]) == 0.0


def test_cross_attention_is_the_plain_path():
    """``attention_forward(kv_x=)`` and ``attention_decode(cross_kv=)``
    against the reference's: keys of another length, no rope, no mask."""
    from repro.models import attention as jax_attn
    from repro_torch.models import attention as attn
    s = setup()
    cfg, jcfg = s["cfg"], s["jcfg"]
    jp = jax_attn.attn_init(jax.random.PRNGKey(9), jcfg, cross=True)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    kv_x = rng.randn(2, 9, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(5)[None], (2, 5))
    jout, _ = jax_attn.attention_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                         jcfg, kv_x=jnp.asarray(kv_x))
    out, kv = attn.attention_forward(p, torch.from_numpy(x),
                                     torch.from_numpy(pos.copy()), cfg,
                                     kv_x=torch.from_numpy(kv_x))
    assert _err(jout, out) <= TOL and kv["k"].shape[1] == 9
    ck = {n: kv[n] for n in ("k", "v")}
    jck = {n: jnp.asarray(kv[n].numpy()) for n in ("k", "v")}
    jd, _ = jax_attn.attention_decode(jp, jnp.asarray(x[:, :1]), 3, None,
                                      jcfg, cross_kv=jck)
    d, c = attn.attention_decode(p, torch.from_numpy(x[:, :1]),
                                 torch.tensor([3, 3]), None, cfg,
                                 cross_kv=ck)
    assert _err(jd, d) <= TOL and c is None


# -------------------------------------------------------------- launchers
def _jax_launcher(argv, frames_of):
    """The reference launcher's body (``repro.launch.train.main``) for the
    encoder-decoder config, its batches' frames replaced by
    ``frames_of(t)``."""
    from repro.data import LMDataConfig as JaxLMDataConfig
    from repro.data import make_lm_batches as jax_make_lm_batches
    args = launcher.parse_args(argv + ["--device", "cpu"])
    s = setup()
    opt = JAX_OPTIMIZERS[args.optimizer]()
    comp = JaxCompressor(args.compress)
    batches = jax_make_lm_batches(JaxLMDataConfig(
        vocab_size=s["jcfg"].vocab_size, seq_len=args.seq_len,
        batch_size=args.batch_size))

    def batch_fn(t):
        b = batches(t)
        return {"frames": jnp.asarray(frames_of(t)), "tokens": b["tokens"],
                "labels": b["labels"]}

    step = jax_make_train_step(
        s["jmodel"].loss_fn, opt, jax_cosine_warmup(args.lr, 5, args.steps),
        precision=JaxPrecisionPolicy(compute_dtype=args.compute_dtype),
        compressor=comp)
    _, hist = jax_train_loop(step, JaxTrainState.create(s["jparams"], opt,
                                                        comp),
                             batch_fn, args.steps,
                             log_every=max(1, args.steps // 10))
    return hist


@pytest.mark.parametrize("compress", ["none", "onebit"])
def test_launcher_matches_jax(compress):
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch-size", "2",
            "--seq-len", "8", "--compress", compress]
    run = launcher.build(launcher.parse_args(argv + ["--device", "cpu"]),
                         params=setup()["params"])
    b0 = run.batch_fn(0)
    cfg = setup()["cfg"]
    assert tuple(b0["frames"].shape) == (2, cfg.max_source_positions,
                                         cfg.d_model)
    assert torch.equal(b0["frames"], run.batch_fn(0)["frames"])
    assert not torch.equal(b0["frames"], run.batch_fn(1)["frames"])
    ref = _jax_launcher(argv, lambda t: run.batch_fn(t)["frames"].numpy())
    _, hist = launcher.train(run)
    lines = [json.loads(x) for x in launcher.json_lines(hist)]
    ref_lines = [json.loads(x) for x in launcher.json_lines(ref)]
    assert [x["step"] for x in lines] == [x["step"] for x in ref_lines] == \
        [0, 1, 2]
    for a, b in zip(lines, ref_lines):
        assert abs(a["loss"] - b["loss"]) <= LOSS_TOL
        assert a["wire_bytes"] == b["wire_bytes"]


def test_launcher_main_smoke_and_layers(capsys):
    """``launch/train.py --arch whisper-large-v3 --smoke --device cpu``;
    ``--layers`` cuts both stacks."""
    hist = launcher.main(["--arch", ARCH, "--smoke", "--steps", "2",
                          "--batch-size", "2", "--seq-len", "6", "--device",
                          "cpu"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert "done in" in capsys.readouterr().out
    cfg = launcher.config(launcher.parse_args(
        ["--arch", ARCH, "--layers", "1", "--device", "cpu"]))
    assert (cfg.num_layers, cfg.encoder_layers, cfg.d_model) == (1, 1, 1280)
    tiny = launcher.config(launcher.parse_args(
        ["--arch", "tinyllama-1.1b", "--smoke", "--layers", "1"]))
    assert tiny.num_layers == 1 and tiny.encoder_layers == 0


def test_serve_launcher_refuses_encoder_decoder():
    with pytest.raises(SystemExit, match="enc-dec serving"):
        serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
