"""The port's optimizers, schedules and precision policy against the JAX
package's, on the CPU.

* Optimizers: every case of ``tests/test_optim.py`` (SGD with momentum 0,
  0.9 and Nesterov, Adam, AdamW(0.001), Adafactor) on its quadratic, and
  on reduced-TinyLlama gradient leaves carried over from the JAX model
  (plus Adam with bf16 moments), at each case's learning rate: the same
  gradients go into both packages for 5 steps, and parameters and
  optimizer state agree within rtol 1e-6 (Adafactor 1e-5: its row/column
  means sum in another order, and its weights are held against the
  distance each travelled, since at lr 0.2 some end near zero).
  Each port optimizer also descends the quadratic as the reference's test
  asks (loss below 5% of its start after 200 steps).
* Schedules: ``constant`` equal; ``cosine_warmup`` bit-equal in the
  warm-up and within one fp32 ulp on the cosine steps, against the
  reference called as a Python function (inside ``jit`` XLA rewrites the
  schedule's division; the trainer tests hold the jitted values).
* Precision: ``stochastic_round`` fed the reference's own uniforms is bit
  for bit the reference's, to bf16 and fp16; the policies cast to the
  reference's dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import precision as jprec
from repro.data import LMDataConfig as JaxLMDataConfig
from repro.data import make_lm_batches as jax_make_lm_batches
from repro.models import build_model as jax_build_model
from repro import optim as jopt
from repro_torch import optim as topt
from repro_torch.configs import get_config
from repro_torch.core import precision as tprec
from repro_torch.core.tree import LeafLayout
from repro_torch.models import build_model
from repro_torch.models.transformer import from_jax_params

torch.set_num_threads(2)

# (name, reference optimizer, port optimizer, lr) of tests/test_optim.py
QUAD_CASES = [
    ("sgd0", jopt.SGD(momentum=0.0), topt.SGD(momentum=0.0), 0.1),
    ("sgd", jopt.SGD(momentum=0.9), topt.SGD(momentum=0.9), 0.05),
    ("nesterov", jopt.SGD(momentum=0.9, nesterov=True),
     topt.SGD(momentum=0.9, nesterov=True), 0.05),
    ("adam", jopt.Adam(), topt.Adam(), 0.05),
    ("adamw", jopt.AdamW(0.001), topt.AdamW(0.001), 0.05),
    ("adafactor", jopt.Adafactor(), topt.Adafactor(), 0.2),
]
MODEL_CASES = QUAD_CASES + [
    ("adam_bf16", jopt.Adam(moment_dtype="bfloat16"),
     topt.Adam(moment_dtype="bfloat16"), 0.05)]
_CACHE = {}


def _rtol(name):
    return 1e-5 if name == "adafactor" else 1e-6


def _quadratic():
    key = jax.random.PRNGKey(0)
    A = jax.random.normal(key, (12, 12))
    A = A @ A.T / 12 + jnp.eye(12)
    x0 = jax.random.normal(jax.random.fold_in(key, 1), (12,))
    return np.asarray(A, np.float32), np.asarray(x0, np.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _state_leaves(name, state, layout=None, tree=None):
    """The optimizer state as a list of arrays in the reference's leaf
    order (the port's trees through ``layout``)."""
    if name.startswith("sgd") or name == "nesterov":
        if not state:
            return []
        return ([_np(x) for x in layout.leaves(state["m"])] if layout
                else [_np(x) for x in jax.tree.leaves(state["m"])])
    if name == "adafactor":
        f = state["f"] if layout else jax.tree.leaves(
            state["f"], is_leaf=lambda d: isinstance(d, dict) and (
                "v" in d or "vr" in d))
        return [_np(d[k]) for d in f for k in sorted(d)]
    if layout:
        return [_np(x) for k in ("m", "v") for x in layout.leaves(state[k])]
    return [_np(x) for k in ("m", "v") for x in jax.tree.leaves(state[k])]


# ------------------------------------------------------------ quadratic
@pytest.mark.parametrize("name,jo,to,lr", QUAD_CASES,
                         ids=[c[0] for c in QUAD_CASES])
def test_optimizer_matches_jax_on_quadratic(name, jo, to, lr):
    A, x0 = _quadratic()
    jp, tp = {"x": jnp.asarray(x0)}, {"x": torch.from_numpy(x0.copy())}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(5):
        # the same gradient function on each side's own parameters
        jg = {"x": jnp.asarray(A @ np.asarray(jp["x"]))}
        tg = {"x": torch.from_numpy(A @ tp["x"].numpy())}
        jp, js = jo.step(jp, jg, js, lr)
        tp, ts = to.step(tp, tg, ts, lr)
    np.testing.assert_allclose(tp["x"].numpy(), np.asarray(jp["x"]),
                               rtol=_rtol(name), atol=0)
    layout = LeafLayout.of_tree(tp)
    for a, b in zip(_state_leaves(name, ts, layout),
                    _state_leaves(name, js)):
        np.testing.assert_allclose(a, b, rtol=_rtol(name), atol=0)


@pytest.mark.parametrize("name,jo,to,lr", QUAD_CASES,
                         ids=[c[0] for c in QUAD_CASES])
def test_optimizer_descends_quadratic(name, jo, to, lr):
    A, x0 = _quadratic()
    A = torch.from_numpy(A.copy())
    params = {"x": torch.from_numpy(x0.copy())}
    state = to.init(params)
    loss = lambda p: float(0.5 * p["x"] @ A @ p["x"])
    l0 = loss(params)
    for _ in range(200):
        params, state = to.step(params, {"x": A @ params["x"]}, state, lr)
    assert loss(params) < l0 * 0.05, name


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros(64, 32), "b": torch.zeros(32)}
    st = topt.Adafactor().init(params)
    # the layout's leaf order: "b" before "w"
    assert st["f"][0]["v"].shape == (32,)
    assert st["f"][1]["vr"].shape == (64,)
    assert st["f"][1]["vc"].shape == (32,)


def test_moment_dtype_and_bytes():
    for mdt, nbytes in (("float32", 4), ("bfloat16", 2)):
        jo, to = jopt.Adam(moment_dtype=mdt), topt.Adam(moment_dtype=mdt)
        assert to.moment_bytes == jo.moment_bytes == nbytes
        assert str(to.mdt) == "torch." + str(jo.mdt)
        assert to.moments_per_param == jo.moments_per_param == 2
        st = to.init({"w": torch.zeros(3, 4)})
        assert st["m"]["w"].dtype == to.mdt and st["t"] == 0
    assert topt.AdamW().weight_decay == jopt.AdamW().weight_decay == 0.01
    assert sorted(topt.OPTIMIZERS) == sorted(jopt.OPTIMIZERS)


# ---------------------------------------------------- model gradients
def _model_setup():
    if not _CACHE:
        jcfg = jax_get_config("tinyllama-1.1b").reduced()
        cfg = get_config("tinyllama-1.1b").reduced()
        jmodel, model = jax_build_model(jcfg), build_model(cfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        batches = jax_make_lm_batches(JaxLMDataConfig(
            vocab_size=jcfg.vocab_size, seq_len=16, batch_size=2))
        grad = jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(
            p, b, compute_dtype=jnp.float32)[0]))
        # five gradients of the initial weights, one per step's batch
        jgrads = [jax.tree.map(np.asarray, grad(jparams, batches(t, 0)))
                  for t in range(5)]
        _CACHE.update(cfg=cfg, model=model,
                      jparams=jax.tree.map(np.asarray, jparams),
                      jgrads=jgrads)
    return _CACHE


@pytest.mark.parametrize("name,jo,to,lr", MODEL_CASES,
                         ids=[c[0] for c in MODEL_CASES])
def test_optimizer_matches_jax_on_model_leaves(name, jo, to, lr):
    s = _model_setup()
    cfg, model = s["cfg"], s["model"]
    jp = jax.tree.map(jnp.asarray, s["jparams"])
    tp = from_jax_params(cfg, s["jparams"])
    layout = model.leaf_layout(tp)
    js, ts = jo.init(jp), to.init(tp, layout=layout)
    # the distance each reference weight travels, step by step
    travel = [np.zeros(np.shape(b), np.float32) for b in jax.tree.leaves(jp)]
    for jg in s["jgrads"]:
        before = [np.asarray(b) for b in jax.tree.leaves(jp)]
        jp, js = jo.step(jp, jax.tree.map(jnp.asarray, jg), js, lr)
        tp, ts = to.step(tp, from_jax_params(cfg, jg), ts, lr, layout=layout)
        travel = [d + np.abs(np.asarray(b) - b0) for d, b, b0
                  in zip(travel, jax.tree.leaves(jp), before)]
    for a, b, d in zip(layout.leaves(tp), jax.tree.leaves(jp), travel):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        if name == "adafactor":
            # XLA's CPU rsqrt is not correctly rounded and the means sum
            # in another order, so each update differs in its last bits;
            # at this lr weights cross zero, where a weight keeps no
            # relative precision: rtol holds on the distance travelled
            assert np.all(np.abs(a - b) <= _rtol(name) * d)
        else:
            np.testing.assert_allclose(a, b, rtol=_rtol(name), atol=0)
    ref_state = _state_leaves(name, js)
    port_state = _state_leaves(name, ts, layout)
    assert len(port_state) == len(ref_state)
    for a, b in zip(port_state, ref_state):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=_rtol(name), atol=0)


# ------------------------------------------------------------ schedules
def test_constant_schedule():
    for lr in (1e-3, 3e-3, 0.1):
        sched, ref = topt.constant(lr), jopt.constant(lr)
        for step in (0, 7, 1000):
            assert np.float32(sched(step)) == np.float32(ref(step))


@pytest.mark.parametrize("peak,warmup,total", [
    (3e-3, 5, 100), (3e-3, 5, 50), (1e-3, 10, 1000), (1.0, 10, 100)])
def test_cosine_warmup_matches_jax(peak, warmup, total):
    sched, ref = (topt.cosine_warmup(peak, warmup, total),
                  jopt.cosine_warmup(peak, warmup, total))
    for step in range(total + 6):
        a, b = np.float32(sched(step)), np.float32(ref(step))
        if step < warmup:
            assert a == b, step
        else:
            assert abs(float(a) - float(b)) <= float(np.spacing(b)), step
    assert sched(0) == 0.0 and sched(total + 5) < 0.2 * peak


# ------------------------------------------------------------ precision
@pytest.mark.parametrize("target", ["bfloat16", "float16"])
def test_stochastic_round_matches_jax(target):
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.standard_normal(4000) * 10.0 ** rng.randint(-6, 4, 4000),
        [0.0, -0.0, 1.0, -1.0, 1e-30, -3e-39, 65504.0, 1 + 2 ** -9,
         1 + 2 ** -12, 2.0 ** -14, 2.0 ** -20]]).astype(np.float32)
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, x.shape))
    ref = jprec.stochastic_round(jnp.asarray(x), jnp.dtype(target), key)
    out = tprec.stochastic_round(torch.from_numpy(x), getattr(torch, target),
                                 u=torch.from_numpy(u.copy()))
    assert out.dtype == getattr(torch, target)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_stochastic_round_is_unbiased():
    x = torch.full((200000,), 1.0 + 2 ** -10)       # 1/8 of a bf16 ulp up
    gen = torch.Generator().manual_seed(0)
    out = tprec.stochastic_round(x, torch.bfloat16, gen=gen).float()
    assert set(out.unique().tolist()) == {1.0, 1.0 + 2 ** -7}
    assert abs(out.mean().item() - x[0].item()) < 2e-5


@pytest.mark.parametrize("name", ["DEFAULT", "FP32", "BF16_COMPUTE",
                                  "BF16_REDUCE", "BF16_EVERYTHING"])
def test_policy_casts_match_jax(name):
    jp, tp = getattr(jprec, name), getattr(tprec, name)
    assert (tp.params_dtype, tp.compute_dtype, tp.reduce_dtype) == \
        (jp.params_dtype, jp.compute_dtype, jp.reduce_dtype)
    for t_dt, j_dt in ((tp.pdt, jp.pdt), (tp.cdt, jp.cdt), (tp.rdt, jp.rdt)):
        assert str(t_dt) == "torch." + str(j_dt)
    jtree = {"w": jnp.ones((2, 3)), "i": jnp.arange(3),
             "l": [jnp.ones(2, jnp.bfloat16)]}
    ttree = {"w": torch.ones(2, 3), "i": torch.arange(3, dtype=torch.int32),
             "l": [torch.ones(2, dtype=torch.bfloat16)]}
    for cast in ("cast_for_compute", "cast_for_reduce"):
        jout = jax.tree.leaves(getattr(jp, cast)(jtree))
        tout = LeafLayout.of_tree(ttree).leaves(getattr(tp, cast)(ttree))
        assert ["torch." + str(a.dtype) for a in jout] == \
            [str(b.dtype) for b in tout]


def test_policy_for():
    assert sorted(tprec.POLICIES) == sorted(jprec.POLICIES)
    for name in tprec.POLICIES:
        assert tprec.policy_for(name).compute_dtype == \
            jprec.policy_for(name).compute_dtype
    with pytest.raises(ValueError, match="unknown precision"):
        tprec.policy_for("fp8")
