"""The port's dry-run path (``launch/specs``, ``steps``, ``cost``,
``dryrun``, ``roofline`` and the production meshes) against the JAX
package's ``launch/``.

Specs: for every (arch x shape) pair on the 16 x 16 and 2 x 16 x 16
meshes, ``param_specs``, ``batch_specs_tree``, ``decode_window``,
``batch_shardable``, ``cache_specs`` under all four cache policies and
``opt_state_specs`` equal the reference's ``tuple(spec)`` leaf for leaf
(a stacked reference leaf's spec is the port's with a leading None).
Bytes: ``build_dryrun``'s ``param_bytes_per_device`` and
``cache_bytes_per_device`` (a meta build) equal the reference's
``_sharded_param_bytes`` over ``jax.eval_shape`` exactly.  Steps:
``make_train_step`` (Adam, and Adafactor from ``choose_optimizer``;
remat, bf16 compute), ``make_prefill_step`` and ``make_serve_step`` at
``.reduced()`` against the reference's builders on the same weights
(``from_jax_params``) and inputs, within 6e-3 in loss (the bf16 bound),
UPDATE_TOL in one step's parameter update and 8 bf16 roundings of the
largest |logit| in logits; remat's gradients equal no-remat's bitwise.  The probe's extrapolation from 1 and 2 layer groups
equals the meta count at 4 groups exactly.  ``model_flops``,
``load_all``, ``_traffic`` and ``_group_size`` equal the reference's.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.core import parallelism as JP
from repro.launch import hlo_analysis as JH
from repro.launch import roofline as JR
from repro.launch import specs as JS
from repro.launch import steps as JST
from repro.models import build_model as jax_build_model
from repro.optim import Adafactor as JAdafactor
from repro.optim import Adam as JAdam
from repro_torch.configs import ARCHS, SKIPS, get_config, get_shape
from repro_torch.configs.base import InputShape
from repro_torch.core.parallelism import param_specs
from repro_torch.core.tree import get_path, leaf_paths, tree_map
from repro_torch.launch import cost, dryrun, roofline, specs, steps
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.optim import Adam

torch.set_num_threads(2)

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
PAIRS = [(a, s) for a in ARCHS for s in SHAPES if (a, s) not in SKIPS]
POLICIES = ("auto", "seq_data", "attn_hints", "attn_hints_seq")
BF16_TOL = 6e-3       # loss: the bf16 bound of the earlier slices
# bf16 logits of ~1-3 are spaced 2^-7 to 2^-6 apart, above BF16_TOL: they
# are held relative to their largest magnitude, at 8 bf16 unit roundings
# (2^-8 each; measured <= 2.2e-2, RecurrentGemma's prefill)
LOGIT_TOL = 8 * 2 ** -8


def _ref_dryrun():
    """The reference's dryrun module; it sets XLA_FLAGS on import, which
    must not leak into this process's jax."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as RD
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return RD


@functools.lru_cache(maxsize=None)
def ref_param_shapes(arch):
    model = jax_build_model(JAX_ARCHS[arch])
    return jax.eval_shape(
        lambda k: model.init(k, dtype=jnp.bfloat16,
                             vocab_pad_multiple=JS.VOCAB_PAD),
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    model = build_model(ARCHS[arch])
    params = model.init(dtype=torch.bfloat16, device="meta",
                        vocab_pad_multiple=specs.VOCAB_PAD)
    return params, model.leaf_layout(params)


def _ref_leaf_specs(tree, spec_tree):
    """{leaf name: tuple(spec)} of a reference tree, names as the port's
    ``LeafLayout.names`` (JAX key paths joined by /)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    specs_flat = jax.tree.structure(tree).flatten_up_to(spec_tree)
    out = {}
    for (path, _), sp in zip(flat, specs_flat):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = tuple(sp)
    return out


def _unstack_cache(cfg, ref_tree):
    """The reference's cache (or cache-spec) tree -> one entry per layer,
    as the port's ``init_cache`` lays caches out: a scan segment's
    stacked leaves give one per group, for each member of the pattern."""
    out = []
    for seg, sub in zip(T.plan_segments(cfg), ref_tree):
        if seg[0] == "plain":
            out.append(("plain", sub))
            continue
        _, pattern, n_groups = seg
        for g in range(n_groups):
            for j in range(len(pattern)):
                out.append(("stacked", sub[j]))
    return out


# ------------------------------------------------------------------ meshes
def test_production_meshes_and_h100_constants():
    m1, m2 = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert specs.mesh_axis_sizes(m1) == {"data": 16, "model": 16}
    assert specs.mesh_axis_sizes(m2) == {"pod": 2, "data": 16, "model": 16}
    assert m2.devices.size == 512 and len(set(m2.devices.flat)) == 512
    assert (PEAK_FLOPS_BF16, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)


# ------------------------------------------------------------------- specs
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, multi_pod):
    jshapes = ref_param_shapes(arch)
    ref = _ref_leaf_specs(jshapes, JP.param_specs(jshapes,
                                                  multi_pod=multi_pod))
    params, layout = port_params(arch)
    pspecs = param_specs(params, multi_pod=multi_pod)
    assert sorted(layout.names) == sorted(ref)
    for i, name in enumerate(layout.names):
        for path in layout.parts[i]:
            got = get_path(pspecs, path)
            want = ref[name][1:] if layout.is_stacked(i) else ref[name]
            assert got == want, (name, got, ref[name])


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_pair_specs_match_reference(arch, shape_name, multi_pod):
    """batch_shardable, batch_specs_tree, decode_window and, for decode
    pairs, cache_specs under every policy."""
    cfg, jcfg = get_config(arch), JAX_ARCHS[arch]
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert specs.batch_shardable(shape, mesh) == \
        JS.batch_shardable(shape, mesh)
    assert specs.decode_window(cfg, shape) == JS.decode_window(jcfg, shape)
    ref_b = JS.batch_specs_tree(jcfg, shape, mesh, multi_pod)
    assert specs.batch_specs_tree(cfg, shape, mesh, multi_pod) == \
        {k: tuple(v) for k, v in ref_b.items()}
    ref_in = JS.train_input_specs(jcfg, shape)
    got_in = specs.train_input_specs(cfg, shape)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in ref_in.items()} \
        == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got_in.items()}
    if shape.kind != "decode":
        return
    window = specs.decode_window(cfg, shape)
    shard_b = specs.batch_shardable(shape, mesh)
    B, L = shape.global_batch, shape.seq_len
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    kw = {} if cfg.is_encoder_decoder else {"window_override": window}
    jc = jax.eval_shape(lambda: jmodel.init_cache(B, L, dtype=jnp.bfloat16,
                                                  **kw))
    pc = model.init_cache(B, L, dtype=torch.bfloat16, device="meta", **kw)
    for policy in POLICIES:
        ref = JS.cache_specs(jc, mesh, multi_pod, shard_b, policy=policy)
        got = specs.cache_specs(pc, mesh, multi_pod, shard_b, policy=policy)
        if cfg.is_encoder_decoder:
            assert got == jax.tree.map(tuple, ref, is_leaf=lambda x:
                                       isinstance(x, jax.sharding.
                                                  PartitionSpec))
            continue
        for li, (kind, sub) in enumerate(_unstack_cache(cfg, ref)):
            for name, sp in sub.items():
                want = tuple(sp)[1:] if kind == "stacked" else tuple(sp)
                assert got[li][name] == want, (policy, li, name)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_state_specs_match_reference(arch):
    """Adam's m / v, or Adafactor's factored vr / vc above 20 B
    parameters, from the param specs."""
    cfg = get_config(arch)
    jopt = JST.choose_optimizer(JAX_ARCHS[arch])
    opt = steps.choose_optimizer(cfg)
    assert type(opt).__name__ == type(jopt).__name__
    jshapes = ref_param_shapes(arch)
    jpspecs = JP.param_specs(jshapes)
    jo = jax.eval_shape(jopt.init, jshapes)
    ref = _ref_leaf_specs(jo, JS.opt_state_specs(jo, jpspecs))
    params, layout = port_params(arch)
    ost = opt.init(params, layout=layout)
    got = specs.opt_state_specs(ost, param_specs(params), layout)
    if isinstance(opt, Adam):
        for key in ("m", "v"):
            for i, name in enumerate(layout.names):
                for path in layout.parts[i]:
                    g = get_path(got[key], path)
                    w = ref[f"{key}/{name}"]
                    assert g == (w[1:] if layout.is_stacked(i) else w)
    else:
        for i, name in enumerate(layout.names):
            for n, sp in got["f"][i].items():
                assert sp == ref[f"f/{name}/{n}"], (name, n)
    # the top-level leaves take their parameter's spec
    sharded = [v for k, v in ref.items() if k.split("/")[1:2] in
               (["embed"], ["lm_head"]) and any(v)]
    assert sharded


# ------------------------------------------------------------------- bytes
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_per_device_bytes_match_reference(arch, multi_pod):
    """param_bytes_per_device of every arch and cache_bytes_per_device of
    its decode pairs (build_dryrun's default policy and run_pair's),
    exactly."""
    RD = _ref_dryrun()
    mesh = make_production_mesh(multi_pod=multi_pod)
    jshapes = ref_param_shapes(arch)
    want_p = RD._sharded_param_bytes(
        jshapes, JP.param_specs(jshapes, multi_pod=multi_pod), mesh)
    jcfg = JAX_ARCHS[arch]
    jmodel = jax_build_model(jcfg)
    for shape_name in ("decode_32k", "long_500k", "train_4k"):
        if (arch, shape_name) in SKIPS:
            continue
        shape = get_shape(shape_name)
        for policy in ("auto", "attn_hints_seq"):
            _, _, _, info = dryrun.build_dryrun(
                arch, shape_name, multi_pod, cache_policy=policy, batch=1)
            assert info["param_bytes_per_device"] == want_p
            assert info["params_analytic"] == jcfg.param_count()
            if shape.kind != "decode":
                assert info["optimizer"] == type(
                    JST.choose_optimizer(jcfg)).__name__
                break
            window = JS.decode_window(jcfg, shape)
            assert info["window_override"] == window
            kw = {} if jcfg.is_encoder_decoder else {
                "window_override": window}
            jc = jax.eval_shape(lambda: jmodel.init_cache(
                shape.global_batch, shape.seq_len, dtype=jnp.bfloat16, **kw))
            cs = JS.cache_specs(jc, mesh, multi_pod,
                                JS.batch_shardable(shape, mesh),
                                policy=policy)
            assert info["cache_bytes_per_device"] == \
                RD._sharded_param_bytes(jc, cs, mesh), (shape_name, policy)


# ------------------------------------------------------------------- steps
STEP_ARCHS = {"tinyllama-1.1b": {}, "deepseek-v2-lite-16b": {},
              "recurrentgemma-9b": {"num_layers": 4},
              "whisper-large-v3": {}}
SB, SS = 2, 16


@functools.lru_cache(maxsize=None)
def step_setup(arch):
    """Reduced configs, the JAX init's fp32 weights in both packages, and
    seeded inputs."""
    over = STEP_ARCHS[arch]
    jcfg, cfg = (jax_get_config(arch).reduced(**over),
                 get_config(arch).reduced(**over))
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    mod = W if cfg.is_encoder_decoder else T
    rng = np.random.RandomState(3)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (SB, SS)),
             "labels": rng.randint(0, cfg.vocab_size, (SB, SS))}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.randn(SB, cfg.max_source_positions,
                                    cfg.d_model).astype(np.float32)
    return (jcfg, cfg, jmodel, model, jparams,
            lambda: mod.from_jax_params(cfg, np_tree), batch)


def _jb(batch):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
            for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                else v) for k, v in batch.items()}


# One step's update (new - old params) against the reference's, over all
# leaves: ||du - du_ref|| / ||du_ref||.  Adam's first update is ~lr * sign(g),
# and bf16 flips the sign of a few near-zero gradients (2 lr each; measured
# <= 0.19, RecurrentGemma); Adafactor's <= 0.05.  A missing update gives 1.
UPDATE_TOL = 0.3


@pytest.mark.parametrize("arch,opt", [(a, "Adam") for a in sorted(STEP_ARCHS)]
                         + [("deepseek-v2-lite-16b", "Adafactor"),
                            ("tinyllama-1.1b", "Adafactor")])
def test_train_step_matches_reference(arch, opt, monkeypatch):
    """The loss, and the parameters after one step against the
    reference's jitted step on the same weights.  Adafactor comes from
    ``choose_optimizer`` with the threshold at 0 in both packages."""
    jcfg, cfg, jmodel, model, jparams, params_fn, batch = step_setup(arch)
    if opt == "Adafactor":
        monkeypatch.setattr(JST, "ADAFACTOR_THRESHOLD", 0)
        monkeypatch.setattr(steps, "ADAFACTOR_THRESHOLD", 0)
    jopt, topt = JST.choose_optimizer(jcfg), steps.choose_optimizer(cfg)
    assert type(jopt).__name__ == type(topt).__name__ == opt
    jstep = jax.jit(JST.make_train_step(jmodel, jopt, remat=True))
    jnew, _, jloss = jstep(jparams, jopt.init(jparams), _jb(batch))
    params, old = params_fn(), params_fn()
    step = steps.make_train_step(model, topt, remat=True)
    new, _, loss = step(params, topt.init(
        params, layout=model.leaf_layout(params)), _tb(batch))
    assert abs(float(loss) - float(jloss)) <= BF16_TOL
    mod = W if cfg.is_encoder_decoder else T
    jnew = mod.from_jax_params(cfg, jax.tree.map(np.asarray, jnew))
    num = den = 0.0
    for path in leaf_paths(old):
        du = get_path(new, path).float() - get_path(old, path).float()
        dj = get_path(jnew, path).float() - get_path(old, path).float()
        assert bool(du.any()) == bool(dj.any()), path   # every leaf moves
        num += float(((du - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    assert (num / den) ** 0.5 <= UPDATE_TOL


def _ref_steps(jmodel, dtype):
    """The reference's prefill and serve step bodies at ``dtype``
    compute (its builders fix bf16)."""
    jcfg = jmodel.cfg

    def prefill(p, b):
        if jcfg.is_encoder_decoder:
            from repro.models import whisper as JW
            enc = JW.encode(p, jcfg, b["frames"], dtype)
            return JW.decode_train(p, jcfg, b["tokens"], enc, dtype)[:, -1:]
        return jmodel.prefill(p, b["tokens"], compute_dtype=dtype)[0]

    def serve(p, c, tok, pos, window):
        kw = {} if jcfg.is_encoder_decoder else {"window_override": window}
        return jmodel.decode_step(p, c, tok, pos, compute_dtype=dtype,
                                  **kw)[0]
    return prefill, serve


def _serve_inputs(cfg, jmodel, model, batch, dtype):
    L = 24
    window = 8 if cfg.family == "dense" else 0      # a ring at pos 5 of 8
    kw = {} if cfg.is_encoder_decoder else {"window_override": window}
    jc = jmodel.init_cache(SB, L, dtype=getattr(jnp, dtype), **kw)
    pc = model.init_cache(SB, L, dtype=getattr(torch, dtype), **kw)
    return window, jc, pc, batch["tokens"][:, :1], 5


@pytest.mark.parametrize("arch", sorted(STEP_ARCHS))
def test_prefill_and_serve_steps_fp32_match_reference(arch):
    """The steps' bodies at fp32 compute against the reference's at fp32
    compute: 1e-4 (the model parity bar); the serve step's MoE routes
    the batch as one group, as the reference's batched decode_step."""
    jcfg, cfg, jmodel, model, jparams, params_fn, batch = step_setup(arch)
    params = params_fn()
    f32 = torch.float32
    jprefill, jserve = _ref_steps(jmodel, jnp.float32)
    pb = _tb({k: v for k, v in batch.items() if k != "labels"})
    if cfg.is_encoder_decoder:
        enc = W.encode(params, cfg, pb["frames"], f32)
        log = W.decode_train(params, cfg, pb["tokens"], enc, f32)[:, -1:]
    else:
        log = model.prefill(params, pb["tokens"], compute_dtype=f32)[0]
    jlog = jprefill(jparams, _jb({k: v for k, v in batch.items()
                                  if k != "labels"}))
    assert log.shape == tuple(jlog.shape)
    assert np.abs(log.detach().numpy() - np.asarray(jlog)).max() <= 1e-4
    window, jc, pc, tok, pos = _serve_inputs(cfg, jmodel, model, batch,
                                             "float32")
    jlog = jserve(jparams, jc, jnp.asarray(tok, jnp.int32), jnp.int32(pos),
                  window)
    kw = {} if cfg.is_encoder_decoder else {"window_override": window,
                                            "moe_per_row": False}
    log, _ = model.decode_step(params, pc,
                               torch.from_numpy(tok.astype(np.int64)),
                               torch.full((SB,), pos), f32, **kw)
    assert np.abs(log.detach().numpy() - np.asarray(jlog)).max() <= 1e-4


# DeepSeek's bf16 steps are left to the fp32 test above: its reduced
# router puts two experts 1.7e-3 apart in probability for one token, so
# bf16 rounding of its input can flip the top-2 choice either way
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "tinyllama-1.1b",
                                  "whisper-large-v3"])
def test_prefill_and_serve_steps_match_reference(arch):
    """The bf16 steps against the reference's builders."""
    jcfg, cfg, jmodel, model, jparams, params_fn, batch = step_setup(arch)
    params = params_fn()
    pb = {k: v for k, v in batch.items() if k != "labels"}
    jlog, _ = jax.jit(JST.make_prefill_step(jmodel))(jparams, _jb(pb))
    log, _ = steps.make_prefill_step(model)(params, _tb(pb))
    assert log.shape == tuple(jlog.shape)
    _logits_close(log, jlog)
    window, jc, pc, tok, pos = _serve_inputs(cfg, jmodel, model, batch,
                                             "bfloat16")
    jlog, _ = jax.jit(JST.make_serve_step(jmodel, window_override=window))(
        jparams, jc, jnp.asarray(tok, jnp.int32), jnp.int32(pos))
    log, _ = steps.make_serve_step(model, window_override=window)(
        params, pc, torch.from_numpy(tok.astype(np.int64)), pos)
    _logits_close(log, jlog)


def _logits_close(got, want):
    """bf16 logits: within LOGIT_TOL of the largest |logit| (a few bf16
    roundings of it)."""
    a, b = got.float().numpy(), np.asarray(want, np.float32)
    assert np.isfinite(a).all()
    assert np.abs(a - b).max() <= LOGIT_TOL * np.abs(b).max()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-lite-16b",
                                  "whisper-large-v3"])
def test_remat_gradients_bitwise(arch):
    _, cfg, _, model, _, params_fn, batch = step_setup(arch)
    grads = []
    for remat in (False, True):
        params = params_fn()
        paths = leaf_paths(params)
        leaves = tree_map(lambda t: t.requires_grad_(), params)
        loss, _ = model.loss_fn(leaves, _tb(batch), remat=remat)
        flat = [get_path(leaves, p) for p in paths]
        grads.append(torch.autograd.grad(loss, flat, allow_unused=True))
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)


# ------------------------------------------------------------------ probes
@pytest.mark.parametrize("arch,over,shape", [
    ("deepseek-v2-lite-16b", {}, InputShape("t", 32, 2, "train")),
    ("deepseek-v2-lite-16b", {}, InputShape("d", 32, 2, "decode")),
    ("recurrentgemma-9b", {}, InputShape("p", 32, 2, "prefill")),
    ("recurrentgemma-9b", {}, InputShape("t", 32, 2, "train")),
    ("tinyllama-1.1b", {}, InputShape("t", 32, 2, "train"))])
def test_probe_extrapolation_is_exact(arch, over, shape):
    """base + 4 * body from the 1- and 2-group counts equals the count of
    the 4-group model (MoE's dense prefix and RG's 3-layer pattern)."""
    cfg = get_config(arch).reduced(num_layers=40, **over)
    c = [dryrun.meta_cost(dryrun._depth_variant(cfg, n), shape)
         for n in (1, 2, 4)]
    assert dryrun._extrap(c[0], c[1], 4.0) == c[2]
    assert c[0]["flops"] > 0 and c[1]["flops"] > c[0]["flops"]


def test_extrapolation_multipliers():
    """The real depths: RecurrentGemma's 38 layers are 12 groups of 3 and
    a tail of 2; DeepSeek's 27 are a dense layer and 26 groups."""
    assert dryrun._extrap_mult(get_config("recurrentgemma-9b")) == 12 + 2 / 3
    assert dryrun._extrap_mult(get_config("deepseek-v2-lite-16b")) == 26
    assert dryrun._extrap_mult(get_config("tinyllama-1.1b")) == 22
    cfg = get_config("deepseek-v2-lite-16b")
    assert dryrun._depth_variant(cfg, 2).num_layers == 3
    assert dryrun._depth_variant(get_config("whisper-large-v3"),
                                 2).encoder_layers == 2


def test_meta_counts():
    """FLOPs of a matmul, bytes of an op (views count 0) and the live /
    peak bytes of meta storage."""
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")
    c, _ = cost.count_cost(lambda: (a @ b).t().contiguous())
    assert c["flops"] == 2 * 64 * 32 * 16
    assert c["bytes_accessed"] == 4 * (64 * 32 + 32 * 16 + 64 * 16) + \
        4 * 2 * 64 * 16
    mm = cost.MetaMemory()
    with mm:
        x = torch.empty(1000, device="meta")          # 4000 B
        y = x * 2                                      # 8000 B live
        v = y.view(10, 100)                            # a view: no bytes
        del x
        z = torch.empty(500, device="meta")            # 6000 B live
        del y, v, z
    assert (mm.peak, mm.live) == (8000, 0)


def test_meta_memory_counts_the_kernel_route():
    """Under meta_as_card the flash entries allocate only their outputs:
    the prefill at S=4096 keeps no [B, H, S, S] scores (the count's
    constant BLAS workspace aside)."""
    from repro_torch.launch.cost import CARD_WORKSPACE_BYTES
    cfg = get_config("tinyllama-1.1b").reduced()
    shape = InputShape("p", 4096, 1, "prefill")
    m = dryrun.meta_memory(dataclasses.replace(cfg, num_layers=1), shape)
    scores = 1 * cfg.num_heads * 4096 * 4096 * 4
    assert m["peak"] - CARD_WORKSPACE_BYTES < scores / 4
    assert m["weights"] > 0


@pytest.mark.parametrize("op", ["softmax_backward", "logsumexp"])
def test_meta_memory_counts_the_card_transients(op):
    """The ops whose CUDA kernels hold a temporary (measured on the card
    by tools/torch_memory_probe.py) count it at the peak, above their
    outputs: the softmax backward its output's bytes, logsumexp its
    input's."""
    from repro_torch.launch.cost import MetaMemory
    with MetaMemory() as mm:
        x = torch.empty(4, 256, device="meta")              # 4096 B
        if op == "softmax_backward":
            g = torch.empty(4, 256, device="meta")          # 4096 B
            out = torch.ops.aten._softmax_backward_data(g, x, -1,
                                                        torch.float32)
            want = 3 * 4096 + 4096
        else:
            out = torch.logsumexp(x, -1)                    # 16 B
            want = 4096 + 16 + 4096
        assert mm.live == want - 4096       # the transient is gone
        del out
    assert mm.peak == want


def test_memory_model_goes_through_its_counts():
    """At a depth of 2 groups (the first fitted depth) the model is the
    meta count at its two fitted batches exactly, the part that does not
    grow with the batch in ``fixed``."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              num_layers=2)
    shape = InputShape("t", 64, 1, "train")
    mem = dryrun.memory_model(cfg, shape)
    for b in dryrun.MEMORY_BATCHES:
        assert mem["fixed"] + b * mem["row"] == \
            dryrun.meta_memory(cfg, shape, b)["peak"]
    assert 0 < mem["fixed"] and 0 < mem["row"]
    assert (mem["fixed2"], mem["row2"]) == (mem["fixed"], mem["row"])


def test_dryrun_cli_on_meta(tmp_path):
    assert dryrun.main(["--arch", "llama3.2-3b", "--shape", "long_500k",
                        "--device", "meta", "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "whisper-large-v3", "--shape",
                        "long_500k", "--probe", "--device", "meta",
                        "--out", str(tmp_path)]) == 0
    recs = {p: json.load(open(tmp_path / p)) for p in os.listdir(tmp_path)}
    rec = recs["llama3.2-3b__long_500k__16x16.json"]
    assert rec["status"] == "ok"
    assert set(rec["collectives"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute", "traffic_weighted"}
    assert rec["collectives"]["traffic_weighted"] > 0
    assert recs["whisper-large-v3__long_500k__16x16__probe.json"][
        "status"] == "skipped"


# ---------------------------------------------------------------- roofline
@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_model_flops_match_reference(arch, shape_name):
    assert roofline.model_flops(arch, shape_name) == \
        JR.model_flops(arch, shape_name)


def test_load_all_matches_reference(tmp_path):
    cost_ = {"flops": 1e15, "bytes_accessed": 1e12}
    recs = {
        "tinyllama-1.1b__train_4k__16x16.json":
            {"status": "ok", "cost": {"flops": 1.0}},
        "tinyllama-1.1b__train_4k__16x16__probe__legacycache.json":
            {"status": "ok", "probe": True, "cost": cost_,
             "collectives": None},
        "tinyllama-1.1b__train_4k__16x16__tp_only.json":
            {"status": "ok", "cost": {"flops": 5.0}},
        "llama3.2-3b__decode_32k__16x16__unrolled.json":
            {"status": "ok", "unrolled": True, "cost": cost_},
        "llama3.2-3b__decode_32k__16x16.json": {"status": "error",
                                                "error": "x"},
        "whisper-large-v3__long_500k__16x16.json":
            {"status": "skipped", "reason": "n/a"},
        "qwen2-vl-7b__prefill_32k__2x16x16__probe.json":
            {"status": "ok", "probe": True, "cost": cost_},
    }
    for name, rec in recs.items():
        arch, shape, mesh = name.split("__")[:3]
        rec.update(arch=arch, shape=shape, mesh=mesh.replace(".json", ""))
        (tmp_path / name).write_text(json.dumps(rec))
    assert roofline.load_all(str(tmp_path)) == JR.load_all(str(tmp_path))


def test_analyze_record_terms():
    rec = {"arch": "tinyllama-1.1b", "shape": "train_4k",
           "cost": {"flops": 2.56e18, "bytes_accessed": 2.56e15},
           "collectives": None}
    row = roofline.analyze_record(rec, 256)
    assert row["compute_s"] == round(1e16 / PEAK_FLOPS_BF16, 6)
    assert row["memory_s"] == round(1e13 / HBM_BW, 6)
    assert row["collective_s"] is None
    assert row["dominant"].startswith("compute")
    rec["collectives"] = {"traffic_weighted": 4.5e16}
    assert roofline.analyze_record(rec, 256)["dominant"] == "collective"


@pytest.mark.parametrize("op", ["all-reduce", "all-gather",
                                "reduce-scatter", "all-to-all",
                                "collective-permute"])
def test_traffic_model_matches_reference(op):
    for s in (1, 2, 16, 256):
        assert cost._traffic(op, 4096, s) == JH._traffic(op, 4096, s)
    for line in ("x = bf16[8] all-reduce(y), replica_groups=[16,16]<=[256]",
                 "x = f32[4] all-gather(y), replica_groups={{0,1,2,3},{4}}",
                 "x = f32[4] collective-permute(y)"):
        assert cost._group_size(line) == JH._group_size(line)
