"""The port's hybrid engine (``repro_torch.parallel``, ``core/pipeline.py``,
``core/parallelism.py``, the Strategy mesh suffix) against the JAX
package's, on the CPU.

* The suffix grammar, ``MeshSpec`` and the ``Strategy`` round-trips of
  tests/test_hybrid.py, run on both packages, and their results equal.
* ``plan_mesh`` (role dims, local shapes, buckets, issue order, shard
  sizes) and the ZeRO memory and wire models equal the reference's.
* ``tensor_copy`` / ``tensor_reduce`` gradients against a dense FFN.
* GPipe and 1F1B (v1, v2) loss and gradients against
  ``repro.core.pipeline`` inside ``shard_map`` (the cases of
  tests/test_pipeline_grad.py), within 1e-5.
* The five checks of ``test_hybrid_acceptance_8dev``, on the port's
  logical devices and held against the reference's numbers: d2.t2.s2
  against the stacked reference and JAX's mesh within 1e-4; ``dK.t1.s1``
  bitwise the plain ``DeviceEngine``; ZeRO-3 cutting the per-device
  state by >= 0.8 D (bytes equal JAX's) with losses within 1e-5 of z0;
  ZeRO-3 AdamW under ``crash:w1@5,resize:4@10``; ``crash_plan`` and
  ``crash:w5@4`` on d2.t2.s2.  The schedules m8 / 1f1b / 1f1b.v1 on the
  composed mesh within 1e-5 of JAX's.
* The 14 ``"bench": "hybrid"`` rows of ``BENCH_pr10.json``: the
  deterministic columns exact, ``loss_last`` equal to its 4 printed
  digits; params and batches drawn by JAX under the non-partitionable
  threefry, as the rows were recorded.
* ``HybridEngine(group=)``, one mesh device per rank of 8 Gloo ranks
  on the CPU (one module-scoped ``launch.dist.spawn``; the rank
  functions are ``tests/torch_dist_ranks.py``'s): every ``SPECS`` and
  ``EXTRA_SPECS`` cell, and 1F1B at v1 on the 4-layer model, bit for bit
  the logical engine's (history, parameters, wire bytes, the state a
  device holds), the 4-worker cells on the group of the first 4 ranks;
  ``bsp/ps/onebit@8:d2.t2.s2.z3`` and ``bsp/ring/none@8:d2.t2.s2.m8.1f1b``
  over the ranks against the JAX engine's runs within 1e-5; and the
  engine's elastic interface over the ranks (``Trainer(group=).fit(
  plan=)``): the 8-device ``RESTART_SPECS`` cells and ZeRO-3 AdamW's
  ``crash:w1@5,resize:4@10`` on the first 4 ranks (ranks 4-7 sit it
  out, rank 3 waits while the mesh has 3 slots) bit for bit the logical
  engine's (losses, parameters, wire bytes, recoveries, rank 0's
  snapshot manifests), the latter also within 1e-5 of the JAX run.

One module-scoped ``run_multidevice`` subprocess (8 virtual devices)
computes every reference number and saves the inputs it used.
"""
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.parallel as J
import torch_dist_ranks as R
from conftest import run_multidevice
from repro.core.pipeline import (bubble_fraction, gpipe_ticks,
                                 onefb_bubble_fraction, onefb_ticks)
from repro.parallel import make_tiny_transformer as jax_tiny
from repro.train import Strategy as JaxStrategy
from repro_torch import parallel as P
from repro_torch.core import pipeline as PL
from repro_torch.core.parallelism import model_axis_dim, param_specs
from repro_torch.launch.dist import spawn
from repro_torch.parallel import (HybridEngine, stacked_loss,
                                  make_tiny_transformer)
from repro_torch.parallel.staged import tensor_copy, tensor_reduce
from repro_torch.train import Strategy, Trainer
from repro_torch.train.data_parallel import DeviceEngine

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_CHILD = r"""
import numpy as np, jax, jax.numpy as jnp, tempfile, time
EXTRA = %(extra)r
from jax.sharding import Mesh, PartitionSpec as P
from repro.core.collectives import shard_map
from repro.core.pipeline import gpipe_forward, onefb_forward, stacked_forward
from repro.train import Strategy, Trainer
from repro.parallel import make_tiny_transformer, stacked_grad_fn
from repro.parallel.staged import tensor_reduce

out = {}
T0 = time.time()
def leaves(p):
    return [np.asarray(x) for x in jax.tree.leaves(p)]
def save(name, p):
    for i, x in enumerate(leaves(p)):
        out[f"{name}/p{i}"] = x

# ------------------------------------------------ the acceptance script
S, D_MODEL, FF = 2, 8, 16
params, model = make_tiny_transformer(S, D_MODEL, FF, seed=0)
save("init", params)
KEY = jax.random.PRNGKey(1)
W_T = jax.random.normal(KEY, (D_MODEL, D_MODEL))
def make_batch(t, w):
    k = jax.random.fold_in(KEY, t * 100 + w)
    x = jax.random.normal(k, (8, D_MODEL))
    return {"x": x, "y": jnp.tanh(x @ W_T)}
out["batch/x"] = np.stack([np.stack([np.asarray(make_batch(t, w)["x"])
                                     for w in range(4)]) for t in range(12)])
out["batch/y"] = np.stack([np.stack([np.asarray(make_batch(t, w)["y"])
                                     for w in range(4)]) for t in range(12)])
LR, STEPS = 0.05, 4
gf = stacked_grad_fn(model)
def ref_run(d_axis):
    p, losses = params, []
    for t in range(STEPS):
        cat = jax.tree.map(lambda *xs: jnp.concatenate(xs),
                           *[make_batch(t, w) for w in range(d_axis)])
        loss, g = gf(p, cat)
        losses.append(float(loss))
        p = jax.tree.map(lambda a, b: a - LR * b, p, g)
    return p, losses
p_ref, l_ref = ref_run(2)
out["ref/losses"] = np.array(l_ref); save("ref", p_ref)
eng = Strategy.parse("bsp/ring/none@8:d2.t2.s2", lr=LR, bucket_mb=1e-4,
                     backend="device").build(model)
p_dev, h_dev, wire = eng.run(params, make_batch, STEPS)
out["mesh/losses"] = np.array([h["loss"] for h in h_dev]); save("mesh", p_dev)
out["mesh/wire"] = np.array(wire)
a = Strategy.parse("bsp/ring/onebit@4", lr=LR, bucket_mb=1e-4,
                   backend="device").build(model)
pa, ha, wa = a.run(params, make_batch, 3)
out["trivial/losses"] = np.array([h["loss"] for h in ha]); save("trivial", pa)
out["trivial/wire"] = np.array(wa)
for z in ("bsp/ring/none@4:d4.adamw", "bsp/ps/none@4:d4.z3.adamw"):
    e = Strategy.parse(z, lr=LR, bucket_mb=1e-4, backend="device").build(model)
    b = e.inner.per_device_state_bytes(e.inner.init(params))
    p, h, w = e.run(params, make_batch, 3)
    out[z + "/losses"] = np.array([x["loss"] for x in h]); save(z, p)
    out[z + "/bytes"] = np.array([b["params"], b["opt"], b["total"]])
strat = Strategy.parse("bsp/ps/none@4:d4.z3.adamw", lr=LR, bucket_mb=1e-4,
                       backend="device")
p_u, h_u, m_u = Trainer(strat).fit(model, params, make_batch, 12)
out["z3u/losses"] = np.array([h["loss"] for h in h_u])
with tempfile.TemporaryDirectory() as d:
    p_e, h_e, m_e = Trainer(strat).fit(
        model, params, make_batch, 12, plan="crash:w1@5,resize:4@10",
        checkpoint_dir=d, checkpoint_every=3)
out["z3e/losses"] = np.array([h["loss"] for h in h_e]); save("z3e", p_e)
out["z3e/meta"] = np.array([m_e["recoveries"][0]["restored_step"],
                            m_e["resizes"], m_e["final_workers"],
                            m_e["executed_steps"]])
strat3d = Strategy.parse("bsp/ring/none@8:d2.t2.s2", lr=LR, bucket_mb=1e-4,
                         backend="device")
with tempfile.TemporaryDirectory() as d:
    p_c, h_c, m_c = Trainer(strat3d).fit(
        model, params, make_batch, 8, plan="crash:w5@4",
        checkpoint_dir=d, checkpoint_every=2)
out["crash/losses"] = np.array([h["loss"] for h in h_c]); save("crash", p_c)
out["crash/meta"] = np.array([m_c["recoveries"][0]["restored_step"],
                              m_c["final_workers"], m_c["executed_steps"]])
for spec, wire in EXTRA:
    e = Strategy.parse(spec, lr=LR, bucket_mb=1e-4, backend="device",
                       wire=wire).build(model)
    p, h, w = e.run(params, make_batch, 3)
    tag = f"extra/{spec}/{wire}"
    out[tag + "/losses"] = np.array([x["loss"] for x in h]); save(tag, p)
    out[tag + "/events"] = np.array([(x.get("worker", -1),
                                      x["max_staleness"]) for x in h])
    out[tag + "/wire"] = np.array(w)
print("ACCEPT", time.time() - T0, flush=True)

# ------------------------------------------- GPipe grads, core level
KEY7 = jax.random.PRNGKey(7)
for n_stages, n_micro in ((2, 1), (2, 3), (2, 4), (4, 3), (4, 6)):
    tag = f"gpipe/{n_stages}/{n_micro}"
    prm, mdl = make_tiny_transformer(n_stages, 8, 16, seed=n_stages)
    stage_fn = lambda sp, x: mdl.stage_fn(sp, x)
    x = jax.random.normal(KEY7, (n_micro, 4, 8))
    tgt = jax.random.normal(jax.random.fold_in(KEY7, 1), (n_micro, 4, 8))
    mesh = Mesh(np.array(jax.devices()[:n_stages]), ("stage",))
    def body(stacked):
        def loss_fn(pl):
            outs = gpipe_forward(
                lambda spp, xx: stage_fn(
                    jax.tree.map(lambda l: l[0], spp), xx), pl, x, "stage")
            l = jnp.mean((outs - tgt) ** 2)
            me = jax.lax.axis_index("stage")
            l = jnp.where(me == n_stages - 1, l, 0.0)
            return tensor_reduce("stage")(l)
        return jax.value_and_grad(loss_fn)(stacked)
    spec = jax.tree.map(lambda _: P("stage"), prm)
    fn = shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=(P(), spec),
                   check_vma=False)
    l_pipe, g_pipe = jax.jit(fn)(prm)
    save(tag + "/params", prm); save(tag + "/grads", g_pipe)
    out[tag + "/x"] = np.asarray(x); out[tag + "/tgt"] = np.asarray(tgt)
    out[tag + "/loss"] = np.array(float(l_pipe))

# ------------------------------------------- 1F1B grads, core level
KEY3 = jax.random.PRNGKey(3)
for n_stages, v, n_micro in ((2, 2, 4), (2, 2, 8), (2, 1, 4), (4, 2, 6),
                             (2, 2, 2), (2, 2, 3)):
    tag = f"onefb/{n_stages}/{v}/{n_micro}"
    lps, mb = 2, 2
    L = n_stages * lps
    ks = jax.random.split(jax.random.fold_in(KEY3, L*31 + v*7 + n_micro), 3)
    W = jax.random.normal(ks[0], (L, 8, 8)) * 0.3
    x = jax.random.normal(ks[1], (n_micro, mb, 8))
    tgt = jax.random.normal(ks[2], (n_micro, mb, 8))
    def stage_fn(sp, xx):
        for j in range(sp["W"].shape[0]):
            xx = jnp.tanh(xx @ sp["W"][j])
        return xx
    cl = lps // v
    perm = np.concatenate([np.arange((c*n_stages + i)*cl,
                                     (c*n_stages + i + 1)*cl)
                           for i in range(n_stages) for c in range(v)])
    mesh = Mesh(np.array(jax.devices()[:n_stages]), ("stage",))
    def body(p):
        def loss_fn(pl):
            outs = onefb_forward(stage_fn, pl, x, "stage", interleave=v)
            l = jnp.mean((outs - tgt) ** 2)
            me = jax.lax.axis_index("stage")
            l = jnp.where(me == n_stages - 1, l, 0.0)
            return tensor_reduce("stage")(l)
        return jax.value_and_grad(loss_fn)(p)
    fn = shard_map(body, mesh=mesh, in_specs=({"W": P("stage")},),
                   out_specs=(P(), {"W": P("stage")}), check_vma=False)
    l_pipe, g_pipe = jax.jit(fn)({"W": W[perm]})
    out[tag + "/W"] = np.asarray(W); out[tag + "/x"] = np.asarray(x)
    out[tag + "/tgt"] = np.asarray(tgt)
    out[tag + "/loss"] = np.array(float(l_pipe))
    out[tag + "/grad"] = np.asarray(g_pipe["W"])[np.argsort(perm)]

# ----------------------- schedules on the d2.t2.s2 composed mesh
params0, model4 = make_tiny_transformer(4, d_model=8, d_ff=16, seed=0)
save("sched/init", params0)
rng = np.random.default_rng(0)
X = rng.standard_normal((16, 8)).astype(np.float32)
Y = rng.standard_normal((16, 8)).astype(np.float32)
out["sched/X"], out["sched/Y"] = X, Y
batches = lambda t, w=0: {"x": jnp.asarray(X), "y": jnp.asarray(Y)}
for spec in ("bsp/ring/none@1", "bsp/ring/none@8:d2.t2.s2.m8",
             "bsp/ring/none@8:d2.t2.s2.m8.1f1b",
             "bsp/ring/none@8:d2.t2.s2.m8.1f1b.v1"):
    p, hist, _ = Trainer(Strategy.parse(spec, lr=0.05)).fit(
        model4, params0, batches, 3)
    out[spec + "/losses"] = np.array([e["loss"] for e in hist])
    save(spec, p)
# ---------- BENCH_pr10's bf16 row on today's jax, its recorded draws
with jax.threefry_partitionable(False):
    bparams, bmodel = make_tiny_transformer(4, 32, 64, seed=0)
    bkey = jax.random.PRNGKey(1)
    bw = jax.random.normal(bkey, (32, 32))
    bx = {(t, w): jax.random.normal(jax.random.fold_in(bkey, t * 100 + w),
                                    (16, 32))
          for t in range(4) for w in range(8)}
bb = {k: {"x": x, "y": jnp.tanh(x @ bw)} for k, x in bx.items()}
eng = Strategy.parse("bsp/ring/none@8:d2.t2.s2.m8.1f1b.bf16", lr=0.01,
                     bucket_mb=1e-3, backend="device").build(bmodel)
st = eng.init(bparams)
for t in range(4):
    st, ev = eng.inner.step(st, lambda t, w: bb[t, w], t)
out["bench_bf16/loss_last"] = np.array(ev[-1]["loss"])
np.savez(%(out)r, **out)
print("DONE", time.time() - T0)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_hybrid")
    run_multidevice(_JAX_CHILD % dict(out=str(d / "out.npz"),
                                      extra=EXTRA_SPECS), n_devices=8)
    return dict(np.load(d / "out.npz"))


def _tree(ref, name):
    """The tiny model's params a reference run saved (leaves in
    ``jax.tree.leaves`` order: w_down, w_up)."""
    return {"w_down": torch.from_numpy(ref[name + "/p0"].copy()),
            "w_up": torch.from_numpy(ref[name + "/p1"].copy())}


def _batches(ref):
    def make_batch(t, w):
        return {"x": torch.from_numpy(ref["batch/x"][t, w].copy()),
                "y": torch.from_numpy(ref["batch/y"][t, w].copy())}
    return make_batch


def _pdiff(p, ref, name):
    return max(float(np.abs(p[k].numpy() - ref[f"{name}/p{i}"]).max())
               for i, k in enumerate(("w_down", "w_up")))


def _ldiff(hist, losses):
    return max(abs(h["loss"] - float(x)) for h, x in zip(hist, losses))


MODEL = make_tiny_transformer(2, 8, 16, device="cpu")[1]
LR = 0.05
# the engine's other paths on the acceptance model, 3 steps each: the
# codec exchanges inside the z0 schedule and the ZeRO bucket update (EF
# telescoping), dgc's sparse bytes, z1/z2 on a composed mesh, qmom, bf16r,
# and the async / sma data axis over a tensor-sharded slot
EXTRA_SPECS = (("bsp/ring/onebit@8:d2.t2.s2", "measured"),
               ("bsp/ps/onebit@8:d2.t2.s2.z1.adamw", "measured"),
               ("bsp/ps/onebit@8:d2.t2.s2.z3", "measured"),
               ("bsp/ps/dgc:0.05@4:d2.s2.z2", "measured"),
               ("bsp/ps/none@8:d2.t2.s2.z1.adamw", "modeled"),
               ("bsp/ps/none@8:d2.t2.s2.z2.adamw", "modeled"),
               ("bsp/ps/none@4:d4.z2.qmom.adamw", "modeled"),
               ("bsp/ring/none@8:d2.t2.s2.bf16r", "modeled"),
               ("bsp/ring/none@8:d2.t2.s2.m4.1f1b.v1.bf16", "modeled"),
               ("ssp:2/ring/onebit@4:d2.t2", "modeled"),
               ("asp/ring/none@4:d2.t2", "modeled"),
               ("sma/ring/none@4:d2.t2", "modeled"))


# ------------------------------------------------------------- grammar
PKGS = {"jax": (J.parse_suffix, J.suffix_spec, J.MeshSpec, JaxStrategy),
        "torch": (P.parse_suffix, P.suffix_spec, P.MeshSpec, Strategy)}


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_mesh_suffix_parse_and_roundtrip(pkg):
    parse_suffix, suffix_spec, MeshSpec, _ = PKGS[pkg]
    fields, named = parse_suffix("d2.t2.s2")
    assert fields["mesh"] == MeshSpec(2, 2, 2)
    assert named["mesh"] and not named["zero"]
    fields, named = parse_suffix("d4.z3.adamw")
    assert (fields["mesh"], fields["zero"], fields["optimizer"]) == \
        (MeshSpec(4, 1, 1), 3, "adamw")
    assert suffix_spec(MeshSpec(2, 2, 2), 3, "adamw", 6) == \
        "d2.t2.s2.z3.m6.adamw"
    assert suffix_spec(MeshSpec(4, 1, 1)) == ""
    for bad in ("d2.q3", "d2.d4", "adamw.adamw", "sgd.adamw", "d", "z9x",
                ""):
        with pytest.raises(ValueError):
            parse_suffix(bad)
    fields, _ = parse_suffix("s2.sgd")
    assert fields["mesh"].stage == 2 and fields["optimizer"] == "sgd"


SUFFIXES = ("d2.t2.s2", "d4.z3.adamw", "s2.sgd", "d2.t2.s2.m8.1f1b.v1",
            "d2.t2.s2.m8.1f1b.bf16", "d8.z2.qmom.adamw", "bf16r.t2.d4",
            "z1.d8.adamw.qmom")


@pytest.mark.parametrize("text", SUFFIXES)
def test_parse_suffix_equals_jax(text):
    jf, jn = J.parse_suffix(text)
    f, n = P.parse_suffix(text)
    assert n == jn
    assert {k: v for k, v in f.items() if k != "mesh"} == \
        {k: v for k, v in jf.items() if k != "mesh"}
    m, jm = f["mesh"], jf["mesh"]
    assert (m.data, m.tensor, m.stage, m.spec(), m.size, m.is_trivial) == \
        (jm.data, jm.tensor, jm.stage, jm.spec(), jm.size, jm.is_trivial)
    args = {k: v for k, v in f.items() if k != "mesh"}
    assert P.suffix_spec(m, **args) == J.suffix_spec(jm, **args)


SPECS = ("bsp/ring/onebit@8:d2.t2.s2", "bsp/ps/none@4:d4.z3.adamw",
         "bsp/allreduce/none@4:d4.t1.s1", "bsp/ring/none@8:d2.t2.s2.m8.1f1b",
         "bsp/ps/none@8:z2.qmom.adamw", "ssp:2/ring/onebit@4:d2.t2",
         "bsp/tree/dgc:0.05@8:d4.s2.bf16r")


@pytest.mark.parametrize("spec", SPECS)
def test_strategy_spec_roundtrip_equals_jax(spec):
    s, js = Strategy.parse(spec), JaxStrategy.parse(spec)
    assert s.spec() == js.spec()
    assert Strategy.parse(s.spec()) == s
    assert s.is_hybrid == js.is_hybrid
    assert s.mesh_spec.spec() == js.mesh_spec.spec()
    for f in ("zero", "optimizer", "micro_batches", "schedule",
              "interleave", "precision", "moments"):
        assert getattr(s, f) == getattr(js, f), f


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_strategy_mesh_rules(pkg):
    _, _, MeshSpec, Strat = PKGS[pkg]
    s = Strat.parse("bsp/ring/onebit@8:d2.t2.s2")
    assert s.mesh == MeshSpec(2, 2, 2) and s.is_hybrid
    assert s.spec() == "bsp/allreduce/onebit@8:d2.t2.s2"
    z = Strat.parse("bsp/ps/none@4:d4.z3.adamw")
    assert (z.zero, z.optimizer, z.is_hybrid) == (3, "adamw", True)
    t = Strat.parse("bsp/allreduce/none@4:d4.t1.s1")
    assert t.mesh is None and not t.is_hybrid
    assert t.spec() == "bsp/allreduce/none@4"
    with pytest.raises(ValueError, match="non-axis"):
        Strat(sync="bsp", arch="ps", workers=4, mesh="d4.z3")
    with pytest.raises(ValueError, match="non-axis"):
        MeshSpec.parse("d4.adamw")
    for bad in ("bsp/ring/none@8:d2.t2", "bsp/ring/none@8:d2.t2.s2.z1",
                "ssp/ring/none@8:d2.t2.s2",
                "bsp+backup:1/ring/none@8:d2.t2.s2",
                "bsp+detect/ps/none@8:d8.z3.adamw", "bsp/ps/none@4:d4.z4"):
        with pytest.raises(ValueError):
            Strat.parse(bad)
    with pytest.raises(ValueError, match="device-only"):
        Strat.parse("bsp/ps/none@4:d4.z2", backend="sim").resolve_backend()
    assert Strat.parse("bsp/ring/none@8:d2.t2.s2").resolve_backend() == \
        "device"


def test_hybrid_cells_build_the_hybrid_engine():
    eng = Strategy.parse("bsp/ring/none@8:d2.t2.s2", backend="device").build(
        MODEL, device="cpu")
    assert isinstance(eng.inner, HybridEngine)
    plain = Strategy.parse("bsp/ring/none@4:d4.t1.s1").build(MODEL,
                                                            device="cpu")
    assert isinstance(plain.inner, DeviceEngine)
    with pytest.raises(ValueError, match="StagedModel"):
        Strategy.parse("bsp/ring/none@8:d2.t2.s2").build(
            lambda p, b: None, device="cpu")


# ------------------------------------------------------------ mesh plan
def _staged_params(layers=4, d=8, f=16):
    return {"w_up": np.zeros((layers, d, f), np.float32),
            "w_down": np.zeros((layers, f, d), np.float32)}


PLAN_CASES = [(P.MeshSpec(2, 2, 2), 1e-4, 0), (P.MeshSpec(4, 1, 1), 1e-4, 0),
              (P.MeshSpec(1, 2, 2), 1e-3, 8), (P.MeshSpec(8, 1, 1), 4.0, 0),
              (P.MeshSpec(2, 1, 4), 1e-4, 6)]


@pytest.mark.parametrize("mesh,bucket_mb,micro", PLAN_CASES,
                         ids=lambda x: getattr(x, "spec", lambda: str(x))())
def test_plan_mesh_equals_jax(mesh, bucket_mb, micro):
    params = _staged_params()
    jmesh = J.MeshSpec(mesh.data, mesh.tensor, mesh.stage)
    plan = P.plan_mesh(params, mesh, staged=True, bucket_mb=bucket_mb,
                       micro_batches=micro)
    jplan = J.plan_mesh(params, jmesh, staged=True, bucket_mb=bucket_mb,
                        micro_batches=micro)
    assert plan.tensor_dims == jplan.tensor_dims
    assert plan.local_shapes == [tuple(x.shape) for x in
                                 jax.tree.leaves(jplan.local_example)]
    assert (plan.buckets, plan.order) == (jplan.buckets, jplan.order)
    assert (plan.bucket_sizes, plan.shard_sizes, plan.micro) == \
        (jplan.bucket_sizes, jplan.shard_sizes, jplan.micro)
    assert plan.n_local_params == jplan.n_local_params
    for zero in (0, 1, 2, 3):
        for opt, mom in (("sgd", "float32"), ("adamw", "float32"),
                         ("adamw", "bfloat16")):
            assert P.state_bytes_per_device(plan, zero, opt, mom) == \
                J.state_bytes_per_device(jplan, zero, opt, mom)
        for gb in (None, 1234):
            assert P.wire_bytes_per_device(plan, zero, gb) == \
                J.wire_bytes_per_device(jplan, zero, gb)


def test_plan_mesh_role_dims_and_rejects_bad_geometry():
    plan = P.plan_mesh(_staged_params(), P.MeshSpec(2, 2, 2), staged=True,
                       bucket_mb=1e-4)
    # w_down (leaf 0) row-parallel on d_ff = dim 1, w_up column-parallel
    # on d_ff = dim 2; the layer dim divides over 2 stages
    assert plan.tensor_dims == [1, 2]
    assert plan.local_shapes == [(2, 8, 8), (2, 8, 8)]
    assert plan.micro == 4
    with pytest.raises(ValueError, match="stage axis"):
        P.plan_mesh(_staged_params(layers=3), P.MeshSpec(1, 1, 2),
                    staged=True)
    with pytest.raises(ValueError, match="divisible by tensor"):
        P.plan_mesh(_staged_params(f=6), P.MeshSpec(1, 4, 1), staged=True)
    with pytest.raises(ValueError, match="model-parallel"):
        P.plan_mesh({"u": np.zeros((4, 8, 8), np.float32)},
                    P.MeshSpec(1, 2, 1), staged=True)
    # the role table over the port's tree paths and the layout's names
    specs = param_specs({"wq": torch.zeros(4, 4), "b": torch.zeros(4),
                         "mlp": {"w_down": torch.zeros(3, 4, 4)}})
    assert specs == {"wq": ("data", "model"), "b": (None,),
                     "mlp": {"w_down": (None, "model", "data")}}
    assert model_axis_dim("segments/0/attn/wo", 3) == 1
    assert model_axis_dim(("layers", 0, "mlp", "w_up"), 2) == 1


# --------------------------------------------- Megatron f / g operators
def test_tensor_copy_and_reduce_gradients_match_dense():
    """A column -> row parallel FFN over 2 logical tensor ranks: loss and
    gradients equal the dense FFN's; a plain sum in place of
    ``tensor_reduce`` would hand each rank T times its cotangent."""
    g = torch.Generator().manual_seed(0)
    T, d, f = 2, 6, 8
    x = torch.randn(5, d, generator=g, dtype=torch.float64)
    w_up = torch.randn(d, f, generator=g, dtype=torch.float64)
    w_dn = torch.randn(f, d, generator=g, dtype=torch.float64)

    def dense(x, u, w):
        return ((x + torch.tanh(x @ u) @ w) ** 2).sum()

    xs, us, ws = (t.clone().requires_grad_() for t in (x, w_up, w_dn))
    dense(xs, us, ws).backward()
    xt, ut, wt = (t.clone().requires_grad_() for t in (x, w_up, w_dn))
    xT = tensor_copy(xt[None].expand(T, 5, d))
    ub = torch.stack(ut.chunk(T, dim=1))          # [T, d, f/T]
    wb = torch.stack(wt.chunk(T, dim=0))          # [T, f/T, d]
    y = tensor_reduce(torch.tanh(xT @ ub) @ wb)
    rows = ((xt[None] + y) ** 2).sum((1, 2))
    assert torch.allclose(rows, rows[0].expand(T))
    rows.sum().backward()                         # each rank seeds 1
    for a, b in ((xs, xt), (us, ut), (ws, wt)):
        assert torch.allclose(a.grad * T, b.grad) if a is xs else \
            torch.allclose(a.grad, b.grad)


# ------------------------------------------------ pipeline gradients
GPIPE_CASES = ((2, 1), (2, 3), (2, 4), (4, 3), (4, 6))


@pytest.mark.parametrize("n_stages,n_micro", GPIPE_CASES)
def test_gpipe_grads_match_jax(ref, n_stages, n_micro):
    tag = f"gpipe/{n_stages}/{n_micro}"
    params = _tree(ref, tag + "/params")
    _, model = make_tiny_transformer(n_stages, 8, 16, device="cpu")
    x = torch.from_numpy(ref[tag + "/x"])
    tgt = torch.from_numpy(ref[tag + "/tgt"])
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    stages = [{k: v[s:s + 1] for k, v in leaves.items()}
              for s in range(n_stages)]
    outs = PL.gpipe_forward(
        lambda sp, xx: model.stage_fn({k: v[0] for k, v in sp.items()}, xx),
        stages, x)
    loss = torch.mean((outs - tgt) ** 2)
    loss.backward()
    assert abs(loss.item() - float(ref[tag + "/loss"])) <= 1e-5
    for i, k in enumerate(("w_down", "w_up")):
        assert np.abs(leaves[k].grad.numpy()
                      - ref[f"{tag}/grads/p{i}"]).max() <= 1e-5
    # the unpipelined reference gives the same loss
    y = PL.stacked_forward(lambda sp, xx: model.stage_fn(sp, xx), params, x)
    assert abs(float(torch.mean((y - tgt) ** 2)) - float(loss)) <= 1e-6
    assert PL.gpipe_ticks(n_stages, n_micro) == gpipe_ticks(n_stages,
                                                             n_micro)
    assert PL.bubble_fraction(n_stages, n_micro) == \
        bubble_fraction(n_stages, n_micro)


ONEFB_CASES = ((2, 2, 4), (2, 2, 8), (2, 1, 4), (4, 2, 6), (2, 2, 2),
               (2, 2, 3))


@pytest.mark.parametrize("n_stages,v,n_micro", ONEFB_CASES)
def test_onefb_grads_match_jax(ref, n_stages, v, n_micro):
    tag = f"onefb/{n_stages}/{v}/{n_micro}"
    lps = 2
    W = torch.from_numpy(ref[tag + "/W"]).requires_grad_()
    x = torch.from_numpy(ref[tag + "/x"])
    tgt = torch.from_numpy(ref[tag + "/tgt"])

    def stage_fn(sp, xx):
        for j in range(sp["W"].shape[0]):
            xx = torch.tanh(xx @ sp["W"][j])
        return xx

    cl = lps // v
    perm = np.concatenate([np.arange((c * n_stages + i) * cl,
                                     (c * n_stages + i + 1) * cl)
                           for i in range(n_stages) for c in range(v)])
    Wp = W[torch.from_numpy(perm)]
    stages = [{"W": Wp[i * lps:(i + 1) * lps]} for i in range(n_stages)]
    outs = PL.onefb_forward(stage_fn, stages, x, interleave=v)
    loss = torch.mean((outs - tgt) ** 2)
    loss.backward()
    assert abs(loss.item() - float(ref[tag + "/loss"])) <= 1e-5
    assert np.abs(W.grad.numpy() - ref[tag + "/grad"]).max() <= 1e-5
    assert PL.onefb_ticks(n_stages, n_micro, v) == onefb_ticks(
        n_stages, n_micro, v)
    assert PL.onefb_bubble_fraction(n_stages, n_micro, v) == \
        onefb_bubble_fraction(n_stages, n_micro, v)


def test_onefb_rejects_bad_geometry():
    st = [{"W": torch.zeros(2, 3, 3)}] * 2
    with pytest.raises(ValueError, match="micro_batches >= stages"):
        PL.onefb_forward(lambda sp, x: x, st, torch.zeros(1, 2, 3))
    with pytest.raises(ValueError, match="not divisible"):
        PL.onefb_forward(lambda sp, x: x, st, torch.zeros(4, 2, 3),
                         interleave=3)


SCHED_SPECS = ("bsp/ring/none@8:d2.t2.s2.m8",
               "bsp/ring/none@8:d2.t2.s2.m8.1f1b",
               "bsp/ring/none@8:d2.t2.s2.m8.1f1b.v1")


@pytest.mark.parametrize("spec", SCHED_SPECS)
def test_schedules_on_composed_mesh_match_jax(ref, spec):
    params = _tree(ref, "sched/init")
    _, model4 = make_tiny_transformer(4, 8, 16, device="cpu")
    batch = {"x": torch.from_numpy(ref["sched/X"]),
             "y": torch.from_numpy(ref["sched/Y"])}
    runs = {}
    for s in ("bsp/ring/none@1", spec):
        runs[s] = Trainer(Strategy.parse(s, lr=0.05), device="cpu").fit(
            model4, params, lambda t, w=0: batch, 3)
        p, hist, _ = runs[s]
        assert _ldiff(hist, ref[s + "/losses"]) <= 1e-5, s
        assert _pdiff(p, ref, s) <= 1e-5, s
    (p0, h0, _), (p1, h1, _) = runs.values()
    assert _ldiff(h1, [h["loss"] for h in h0]) <= 1e-5
    # the 1f1b virtual-stage row order is undone on the way out
    assert max(float((p0[k] - p1[k]).abs().max()) for k in p0) <= 1e-5


# ------------------------------------------ the five acceptance checks
def test_mesh_matches_stacked_reference(ref):
    params = _tree(ref, "init")
    mb = _batches(ref)
    eng = Strategy.parse("bsp/ring/none@8:d2.t2.s2", lr=LR, bucket_mb=1e-4,
                         backend="device").build(MODEL, device="cpu")
    assert isinstance(eng.inner, HybridEngine)
    p, hist, wire = eng.run(params, mb, 4)
    assert _ldiff(hist, ref["ref/losses"]) <= 1e-4
    assert _pdiff(p, ref, "ref") <= 1e-4
    assert _ldiff(hist, ref["mesh/losses"]) <= 1e-5
    assert _pdiff(p, ref, "mesh") <= 1e-5
    assert wire == int(ref["mesh/wire"]) > 0
    # and the port's own stacked reference
    q = {k: v.clone() for k, v in params.items()}
    for t in range(4):
        cat = {k: torch.cat([mb(t, w)[k] for w in range(2)]) for k in "xy"}
        leaves = {k: v.requires_grad_() for k, v in q.items()}
        loss = stacked_loss(MODEL, leaves, cat)
        loss.backward()
        assert abs(float(loss) - hist[t]["loss"]) <= 1e-4
        q = {k: (v - LR * v.grad).detach() for k, v in leaves.items()}
    assert max(float((q[k] - p[k]).abs().max()) for k in q) <= 1e-4


def test_trivial_mesh_is_bitwise_the_device_engine(ref):
    params = _tree(ref, "init")
    mb = _batches(ref)
    a = Strategy.parse("bsp/ring/onebit@4", lr=LR, bucket_mb=1e-4,
                       backend="device").build(MODEL, device="cpu")
    b = Strategy.parse("bsp/ring/onebit@4:d4.t1.s1", lr=LR, bucket_mb=1e-4,
                       backend="device").build(MODEL, device="cpu")
    assert type(a.inner) is type(b.inner) is DeviceEngine
    pa, ha, wa = a.run(params, mb, 3)
    pb, hb, wb = b.run(params, mb, 3)
    assert [h["loss"] for h in ha] == [h["loss"] for h in hb]
    assert wa == wb == int(ref["trivial/wire"])
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert _ldiff(ha, ref["trivial/losses"]) <= 1e-5
    assert _pdiff(pa, ref, "trivial") <= 1e-5


def test_zero3_state_bytes_and_trajectory(ref):
    params = _tree(ref, "init")
    mb = _batches(ref)
    D = 4
    runs = {}
    for spec in ("bsp/ring/none@4:d4.adamw", "bsp/ps/none@4:d4.z3.adamw"):
        eng = Strategy.parse(spec, lr=LR, bucket_mb=1e-4,
                             backend="device").build(MODEL, device="cpu")
        b = eng.inner.per_device_state_bytes(eng.inner.init(params))
        assert [b["params"], b["opt"], b["total"]] == \
            ref[spec + "/bytes"].tolist()
        p, h, _ = eng.run(params, mb, 3)
        assert _ldiff(h, ref[spec + "/losses"]) <= 1e-5, spec
        assert _pdiff(p, ref, spec) <= 1e-5, spec
        runs[spec] = (b, h)
    (b0, h0), (b3, h3) = runs.values()
    assert b0["total"] / b3["total"] >= 0.8 * D
    assert _ldiff(h3, [h["loss"] for h in h0]) <= 1e-5


def test_zero3_adamw_survives_crash_and_resize(ref):
    params = _tree(ref, "init")
    mb = _batches(ref)
    strat = Strategy.parse("bsp/ps/none@4:d4.z3.adamw", lr=LR,
                           bucket_mb=1e-4, backend="device")
    _, h_u, _ = Trainer(strat, device="cpu").fit(MODEL, params, mb, 12)
    assert _ldiff(h_u, ref["z3u/losses"]) <= 1e-5
    with tempfile.TemporaryDirectory() as d:
        p_e, h_e, m_e = Trainer(strat, device="cpu").fit(
            MODEL, params, mb, 12, plan="crash:w1@5,resize:4@10",
            checkpoint_dir=d, checkpoint_every=3)
    (r,) = m_e["recoveries"]
    assert r["kind"] == "crash" and r["lost_worker"] == 1
    assert m_e["resizes"] == 1 and m_e["final_workers"] == 4
    assert [r["restored_step"], m_e["resizes"], m_e["final_workers"],
            m_e["executed_steps"]] == ref["z3e/meta"].tolist()
    lu, le = h_u[-1]["loss"], h_e[-1]["loss"]
    assert np.isfinite(le) and le <= 4 * max(lu, h_u[0]["loss"] / 4)
    assert _ldiff(h_e, ref["z3e/losses"]) <= 1e-5
    assert _pdiff(p_e, ref, "z3e") <= 1e-5


def test_crash_drops_a_whole_data_replica(ref):
    params = _tree(ref, "init")
    strat3d = Strategy.parse("bsp/ring/none@8:d2.t2.s2", lr=LR,
                             bucket_mb=1e-4, backend="device")
    eng3d = strat3d.build(MODEL, device="cpu")
    assert eng3d.inner.crash_plan(5) == (4, (1,))
    assert eng3d.inner.data_streams == 2
    eng3d.set_slowdown(5, 2.0)
    assert eng3d.inner.slowdowns == [1.0, 2.0]
    with pytest.raises(ValueError):
        eng3d.set_slowdown(9, 2.0)
    with tempfile.TemporaryDirectory() as d:
        p_c, h_c, m_c = Trainer(strat3d, device="cpu").fit(
            MODEL, params, _batches(ref), 8, plan="crash:w5@4",
            checkpoint_dir=d, checkpoint_every=2)
    (r,) = m_c["recoveries"]
    assert r["kind"] == "crash" and m_c["final_workers"] == 4
    assert [r["restored_step"], m_c["final_workers"],
            m_c["executed_steps"]] == ref["crash/meta"].tolist()
    assert _ldiff(h_c, ref["crash/losses"]) <= 1e-5
    assert _pdiff(p_c, ref, "crash") <= 1e-5


# bf16 compute rounds on the CPU other than XLA does (see the bench rows):
# the reference's own d2.t2.s2 and @2 runs of this bf16 model part by
# 3.9e-3 in step 1's loss, the port's from JAX's mesh by 5.2e-3
EXTRA_TOL = {"bf16": 6e-3}      # bf16 and bf16r compute in bf16


@pytest.mark.parametrize("spec,wire", EXTRA_SPECS)
def test_engine_paths_match_jax(ref, spec, wire):
    tag = f"extra/{spec}/{wire}"
    eng = Strategy.parse(spec, lr=LR, bucket_mb=1e-4, backend="device",
                         wire=wire).build(MODEL, device="cpu")
    assert isinstance(eng.inner, HybridEngine)
    p, hist, w = eng.run(_tree(ref, "init"), _batches(ref), 3)
    tol = next((v for k, v in EXTRA_TOL.items() if k in spec), 1e-5)
    assert [(h.get("worker", -1), h["max_staleness"]) for h in hist] == \
        [tuple(e) for e in ref[tag + "/events"].tolist()]
    assert _ldiff(hist, ref[tag + "/losses"]) <= tol
    assert _pdiff(p, ref, tag) <= tol
    assert w == int(ref[tag + "/wire"])


# ------------------------------------------------ traces and snapshots
@pytest.mark.parametrize("stages,micro,schedule,v", [
    (2, 4, "gpipe", 1), (4, 8, "gpipe", 1), (3, 7, "gpipe", 1),
    (2, 8, "1f1b", 2), (4, 6, "1f1b", 1)])
def test_emit_pipeline_trace_equals_jax(stages, micro, schedule, v):
    from repro.obs import trace as JT
    from repro.parallel.engine import emit_pipeline_trace as jax_emit
    from repro_torch.obs import trace as PT
    from repro_torch.obs.analyze import pipeline_accounting
    from repro_torch.parallel.engine import emit_pipeline_trace
    jrec, rec = JT.TraceRecorder(), PT.TraceRecorder()
    jax_emit(jrec, stages, micro, schedule=schedule, interleave=v,
             clock=("train_step", 0))
    emit_pipeline_trace(rec, stages, micro, schedule=schedule,
                        interleave=v, clock=("train_step", 0))
    assert PT.canonical_bytes(PT.strip_wall(rec.to_chrome())) == \
        JT.canonical_bytes(JT.strip_wall(jrec.to_chrome()))
    pp = pipeline_accounting(rec.to_chrome())
    assert pp["rel_err_max"] == pytest.approx(0.0, abs=1e-5)
    emit_pipeline_trace(PT.NullRecorder(), stages, micro)


def test_traced_hybrid_run_equals_untraced(ref):
    """A traced d2.t2.s2 run: the same losses as untraced, one compute
    span, the z0 exchange and the pipeline schedule per step."""
    from repro_torch.obs.trace import find_spans, tracing, validate_trace
    params, mb = _tree(ref, "init"), _batches(ref)

    def run():
        return Strategy.parse("bsp/ring/none@8:d2.t2.s2", lr=LR,
                              bucket_mb=1e-4).build(
            MODEL, device="cpu").run(params, mb, 2)[1]

    plain = run()
    with tracing() as rec:
        traced = run()
    tr = rec.to_chrome()
    validate_trace(tr)
    assert [h["loss"] for h in traced] == [h["loss"] for h in plain]
    assert len(find_spans(tr, "compute")) == 2
    assert len(find_spans(tr, "exchange")) == 2
    assert len(find_spans(tr, "pipe")) == 2


RESTART_SPECS = list(R.RESTART_SPECS)


@pytest.mark.parametrize("spec,plan", RESTART_SPECS)
def test_hybrid_snapshots_restore_bitwise(tmp_path, spec, plan):
    """Every state layout through export_state / checkpoint / import_state:
    z0 AdamW trees with EF and the 1f1b row order, z1 bf16 moment shards,
    z3 parameter shards with EF, z2 across a crash and a resize.  A
    restart is bitwise an uninterrupted run; the crash rolls back, drops
    one data replica and grows it back."""
    params, model = make_tiny_transformer(4, 8, 16, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(5)
    xs = [torch.randn(8, 8, generator=gen) for _ in range(4)]
    batches = lambda t, w: {"x": xs[w], "y": torch.tanh(xs[w])}  # noqa
    strat = Strategy.parse(spec, lr=0.02, bucket_mb=1e-4)
    p_u, h_u, _ = Trainer(strat, device="cpu").fit(model, params, batches,
                                                   6)
    p_r, h_r, m_r = Trainer(strat, device="cpu").fit(
        model, params, batches, 6, plan=plan,
        checkpoint_dir=str(tmp_path), checkpoint_every=2)
    if plan.startswith("restart"):
        assert [h["loss"] for h in h_r] == [h["loss"] for h in h_u]
        assert all(torch.equal(p_u[k], p_r[k]) for k in p_u)
        assert m_r["recoveries"][0]["lost_steps"] == 0
    else:
        (r,) = m_r["recoveries"]
        assert (r["kind"], r["restored_step"]) == ("crash", 2)
        assert m_r["resizes"] == 1 and m_r["final_workers"] == 4
        assert all(np.isfinite(h["loss"]) for h in h_r)
    eng = strat.build(model, device="cpu")
    arrays, meta = eng.export_state(eng.init(params))
    with pytest.raises(ValueError, match="schedule/precision"):
        eng.import_state(arrays, dict(meta, precision="bf16"))
    with pytest.raises(ValueError, match="reshard the engine first"):
        eng.import_state(arrays, dict(meta, num_workers=2))


# ------------------------------------------------- BENCH_pr10 hybrid rows
BENCH_SPECS = [
    "bsp/ring/none@8:d8", "bsp/ring/none@8:d4.s2", "bsp/ring/none@8:d4.t2",
    "bsp/ring/none@8:d2.t2.s2", "bsp/ring/onebit@8:d2.t2.s2",
    "bsp/ring/none@8:d8.adamw", "bsp/ps/none@8:d8.z1.adamw",
    "bsp/ps/none@8:d8.z2.adamw", "bsp/ps/none@8:d8.z3.adamw",
    "bsp/ps/none@8:d2.t2.s2.z3.adamw", "bsp/ring/none@8:d2.t2.s2.m8",
    "bsp/ring/none@8:d2.t2.s2.m8.1f1b",
    "bsp/ring/none@8:d2.t2.s2.m8.1f1b.bf16",
    "bsp/ps/none@8:d8.z2.qmom.adamw"]
_BENCH = {}


def _bench_inputs():
    """benchmarks/hybrid_bench.py's model and batches, drawn by JAX with
    the non-partitionable threefry the rows were recorded under."""
    if not _BENCH:
        with jax.threefry_partitionable(False):
            jparams, _ = jax_tiny(4, 32, 64, seed=0)
            key = jax.random.PRNGKey(1)
            w_t = jax.random.normal(key, (32, 32))
            xs = {}
            for t in range(4):
                for w in range(8):
                    x = jax.random.normal(jax.random.fold_in(key,
                                                             t * 100 + w),
                                          (16, 32))
                    xs[t, w] = {"x": torch.from_numpy(np.array(x)),
                                "y": torch.from_numpy(np.array(
                                    jnp.tanh(x @ w_t)))}
        _BENCH["params"] = {k: torch.from_numpy(np.array(v))
                            for k, v in jparams.items()}
        _BENCH["batches"] = xs
        with open(os.path.join(ROOT, "BENCH_pr10.json")) as f:
            _BENCH["rows"] = [r for r in map(json.loads, f)
                              if r.get("bench") == "hybrid"]
    return _BENCH


def _bench_row(spec, baseline, stage_units, opt_bytes):
    """One row of hybrid_bench.py's matrix on the port (its column
    rules, the wall time left out)."""
    b = _bench_inputs()
    _, model = make_tiny_transformer(4, 32, 64, device="cpu")
    strat = Strategy.parse(spec, lr=0.01, bucket_mb=1e-3, backend="device")
    engine = strat.build(model, device="cpu")
    st = engine.init(b["params"])
    hist = []
    for t in range(4):
        st, ev = engine.inner.step(st, lambda t, w: b["batches"][t, w], t)
        hist.extend(ev)
    mets = engine.metrics()
    state = engine.inner.per_device_state_bytes(st)
    mesh = strat.mesh_spec
    key = (strat.optimizer, mesh.tensor, mesh.stage)
    if strat.zero == 0:
        baseline[key] = state["total"]
    row = {
        "strategy": strat.spec(), "mesh": mesh.spec(), "zero": strat.zero,
        "wire_bytes_per_step": engine.inner.wire_bytes() // 4,
        "modeled_data_bytes_per_dev": mets.get("modeled_data_bytes_per_dev"),
        "modeled_pipeline_bytes_per_dev":
            mets.get("modeled_pipeline_bytes_per_dev", 0),
        "modeled_tensor_bytes_per_dev":
            mets.get("modeled_tensor_bytes_per_dev", 0),
        "state_bytes_per_dev": state["total"],
        "state_param_bytes_per_dev": state["params"],
        "state_opt_bytes_per_dev": state["opt"],
        "loss_last": round(hist[-1]["loss"], 4)}
    if strat.schedule != "gpipe":
        row["interleave"] = int(mets.get("interleave", 1))
    if mesh.stage > 1:
        micro = engine.inner.plan.micro
        if strat.schedule == "1f1b":
            v = int(mets.get("interleave", 1))
            ticks = PL.onefb_ticks(mesh.stage, micro, v)
            units = ticks / v
            row["analytic_bubble"] = round(
                PL.onefb_bubble_fraction(mesh.stage, micro, v), 4)
        else:
            ticks = units = PL.gpipe_ticks(mesh.stage, micro)
            row["analytic_bubble"] = round(
                PL.bubble_fraction(mesh.stage, micro), 4)
        row["modeled_step_ticks"] = ticks
        row["modeled_stage_units"] = round(units, 2)
        sk = (mesh.spec(), micro)
        if strat.schedule == "gpipe":
            stage_units[sk] = units
        elif sk in stage_units:
            row["modeled_speedup_vs_gpipe"] = round(stage_units[sk] / units,
                                                    3)
    okey = (strat.zero, strat.optimizer, mesh.spec())
    if strat.moments == "float32":
        opt_bytes.setdefault(okey, state["opt"])
    elif okey in opt_bytes:
        row["moment_bytes_cut"] = round(opt_bytes[okey] / state["opt"], 2)
    base = baseline.get(key)
    if strat.zero == 3 and base:
        row["state_reduction_vs_z0"] = round(base / state["total"], 2)
    return row, mets


# the rows' loss_last to its 4 printed digits, but for the bf16 row: the
# JAX package no longer reproduces its recorded 3.9347 either (today's
# XLA rounds its bf16 chain otherwise: 3.9335), so the row is held to the
# gap measured against it (port 3.9337) and to today's JAX within 5e-4
# (ROADMAP "Recorded differences")
BF16_ROW_GAP, BF16_JAX_GAP = 1e-3, 5e-4


def test_bench_pr10_hybrid_rows(ref):
    """The 14 hybrid rows in hybrid_bench.py's order (the ZeRO-3, 1F1B and
    qmom columns are relative to earlier rows)."""
    rows = {r["strategy"]: r for r in _bench_inputs()["rows"]}
    assert len(rows) == len(BENCH_SPECS) == 14
    baseline, stage_units, opt_bytes = {}, {}, {}
    for spec in BENCH_SPECS:
        got, mets = _bench_row(spec, baseline, stage_units, opt_bytes)
        want = rows[got["strategy"]]
        for k, v in got.items():
            if k == "loss_last":
                continue
            assert v == want.get(k, 0 if "bytes_per_dev" in k else None), \
                (spec, k, v, want.get(k))
        for k in ("analytic_bubble", "modeled_step_ticks",
                  "modeled_speedup_vs_gpipe", "moment_bytes_cut",
                  "state_reduction_vs_z0"):
            assert (k in got) == (k in want), (spec, k)
        if "bf16" in spec:
            assert abs(got["loss_last"] - want["loss_last"]) <= \
                BF16_ROW_GAP + 1e-9, (spec, got["loss_last"])
            assert abs(got["loss_last"] - float(
                ref["bench_bf16/loss_last"])) <= BF16_JAX_GAP
        else:
            assert got["loss_last"] == want["loss_last"], spec
        if "analytic_state_bytes" in mets:
            a = mets["analytic_state_bytes"]
            opt = got["state_opt_bytes_per_dev"]
            assert a["params"] == got["state_param_bytes_per_dev"]
            assert a["opt"] == (opt - 4 if opt else 0)


# ------------------------------------------- the mesh over process ranks
def _rank_inputs(ref):
    """The cells' inputs: the acceptance model's params and its batches
    (4 slots of 8 rows per step), and the schedule cells' 4-layer model
    with its one 16-row batch."""
    x4, y4 = (torch.from_numpy(ref["sched/" + k][None, None].copy())
              for k in ("X", "Y"))
    return {"tiny2": (_tree(ref, "init"), torch.from_numpy(ref["batch/x"]),
                      torch.from_numpy(ref["batch/y"])),
            "tiny4": (_tree(ref, "sched/init"), x4, y4)}


# the hybrid engine's elastic interface over the ranks: the 8-device
# RESTART_SPECS cells, and ZeRO-3 AdamW through crash:w1@5,resize:4@10
# (test_zero3_adamw_survives_crash_and_resize) over the first 4 ranks
Z3E_CELL = ("bsp/ps/none@4:d4.z3.adamw", "crash:w1@5,resize:4@10", 12, 3,
            LR)
ELASTIC_RANK_CELLS = tuple((c, "restart") for c in R.restart_cells(8)) + (
    (Z3E_CELL, "tiny2"),)


@pytest.fixture(scope="module")
def rank_runs(ref, tmp_path_factory):
    inputs = dict(_rank_inputs(ref), restart=R.restart_inputs())
    root = str(tmp_path_factory.mktemp("hybrid_elastic_ranks"))
    return spawn(R.hybrid_rank, 8, "gloo", device="cpu",
                 args=(inputs, R.HYBRID_CELLS, ELASTIC_RANK_CELLS, root),
                 timeout_s=240)


def _cell_size(spec):
    return int(spec.split("@")[1].split(":")[0])


@pytest.mark.parametrize("cell", R.HYBRID_CELLS,
                         ids=["-".join(c) for c in R.HYBRID_CELLS])
def test_mesh_over_ranks_matches_logical(ref, rank_runs, cell):
    hist, params, nbytes, state = R.hybrid_cell(*cell, _rank_inputs(ref))
    assert len(hist) == R.HYBRID["steps"] * (
        2 if cell[0].split("/")[0].split(":")[0] in ("ssp", "asp") else 1)
    for r in range(_cell_size(cell[0])):
        got = rank_runs[r][cell]
        assert got[0] == hist
        assert all(torch.equal(got[1][k], params[k]) for k in params)
        assert got[2] == nbytes
        if cell[0].startswith("bsp"):
            # what a rank holds is what the logical mesh charges a device
            assert got[3] == state
    # ranks past a 4-device mesh sit the cell out
    assert all(cell not in r for r in rank_runs[_cell_size(cell[0]):])


JAX_RANK_CELLS = {("bsp/ps/onebit@8:d2.t2.s2.z3", "measured", "tiny2"):
                  "extra/bsp/ps/onebit@8:d2.t2.s2.z3/measured",
                  ("bsp/ring/none@8:d2.t2.s2.m8.1f1b", "modeled", "tiny4"):
                  "bsp/ring/none@8:d2.t2.s2.m8.1f1b"}


@pytest.mark.parametrize("cell", list(JAX_RANK_CELLS),
                         ids=[c[0] for c in JAX_RANK_CELLS])
def test_mesh_over_ranks_matches_jax(ref, rank_runs, cell):
    tag = JAX_RANK_CELLS[cell]
    for r in rank_runs:
        hist, params, nbytes, _ = r[cell]
        assert _ldiff(hist, ref[tag + "/losses"]) <= 1e-5
        assert _pdiff(params, ref, tag) <= 1e-5
        if tag.startswith("extra/"):
            assert nbytes == int(ref[tag + "/wire"])


_ELASTIC = {}


def _logical_elastic(ref, cell, key, root):
    if cell not in _ELASTIC:
        inputs = dict(_rank_inputs(ref), restart=R.restart_inputs())
        _ELASTIC[cell] = R.hybrid_elastic_cell(
            *cell, inputs[key], str(root / f"logical{len(_ELASTIC)}"))
    return _ELASTIC[cell]


@pytest.mark.parametrize("cell,key", ELASTIC_RANK_CELLS,
                         ids=[f"{c[0]}-{c[1]}" for c, _ in
                              ELASTIC_RANK_CELLS])
def test_elastic_mesh_over_ranks_matches_logical(ref, rank_runs, cell, key,
                                                 tmp_path_factory):
    """reshard / export_state / import_state over the ranks: losses,
    parameters, wire bytes and recoveries bit for bit the logical
    engine's, rank 0's snapshots file for file its (the others write
    none); ranks past a 4-device mesh sit the cell out."""
    hist, params, nbytes, recs, resizes, final, snaps = _logical_elastic(
        ref, cell, key, tmp_path_factory.mktemp("hybrid_elastic_logical"))
    n = _cell_size(cell[0])
    assert final == n and snaps
    for r in range(n):
        got = rank_runs[r][cell]
        assert got[0] == hist
        assert all(torch.equal(got[1][k], params[k]) for k in params)
        assert got[2] == nbytes
        assert got[3] == recs and got[4] == resizes and got[5] == final
        assert got[6] == (snaps if r == 0 else None)
    assert all(cell not in r for r in rank_runs[n:])


def test_zero3_crash_and_resize_over_ranks_matches_jax(ref, rank_runs):
    """test_zero3_adamw_survives_crash_and_resize over 4 ranks: a crash
    shrinks the mesh to 3 ranks (rank 3 waits), the resize grows it back,
    and every rank ends within 1e-5 of the JAX engine's run."""
    for r in rank_runs[:4]:
        hist, params, _, recs, resizes, final, _ = r[Z3E_CELL]
        (rec,) = recs
        assert rec["kind"] == "crash" and rec["lost_worker"] == 1
        assert [rec["restored_step"], resizes, final,
                len(hist) + rec["lost_steps"]] == ref["z3e/meta"].tolist()
        assert _ldiff(hist, ref["z3e/losses"]) <= 1e-5
        assert _pdiff(params, ref, "z3e") <= 1e-5
