"""The port's communication plane with encoded payloads inside the
schedules (``wire="measured"``) against the JAX package's.

* Byte models: ``schedule_tx_bytes``, ``per_device_bytes``,
  ``fp32_schedule_bytes`` and ``model_error_factor`` equal the
  reference's for every topology x codec x n in {2, 4, 8, 16}, the stored
  counterexample of ``test_comm_plane.py::test_wire_bytes_property``
  (n=2, length=130: 34 B) included.
* Compressed exchanges at n=4 over the five topologies: for ``none``,
  ``onebit`` and ``dgc`` against JAX's ``compressed_allreduce_ef`` run on
  4 virtual devices (reduced sums and next residuals within 1e-6 of the
  largest |sum|, sparse counts exact); for all five codecs on the port
  alone, every worker decodes the same sum and the EF telescoping
  invariant of ``test_comm_plane.py`` holds (gap < 1e-5).
* The measured engine: ``bsp/ring/{onebit,dgc}@8`` against the JAX engine
  (reduced TinyLlama, JAX-initialised weights, 2 steps: losses within
  1e-4, measured bytes exact); ``bsp/*/none`` bitwise equal under modeled
  and measured; the measured wire ordering onebit < terngrad < qsgd <
  none; dgc's per-step wire following a degenerate step 0; and the JAX
  8-device acceptance cell, ``bsp/ring/onebit@8`` measured, 10 steps.
* The parameter-server exchange (``arch="ps"``): ``CommPlan.ps_exchange``
  against JAX's on 4 virtual devices for onebit, dgc, terngrad and qsgd
  (new parameters and EF within 1e-6 of the largest, sparse counts exact;
  JAX's uniform draws, one per hop, bucket and worker, are fed to the
  stochastic codecs); ``measured_step_tx_bytes("ps")`` equal to JAX's for
  every codec and n in {2, 4, 8}; and the measured ``bsp/ps/onebit@8``
  engine against the JAX engine as the ring cells above.
"""
import jax
import numpy as np
import pytest
import torch

from conftest import run_multidevice
from repro.comm import codecs as JCD
from repro.comm import transport as JT
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.comm import codecs as TCD
from repro_torch.comm import transport as TT
from repro_torch.configs import get_config
from repro_torch.data import LMDataConfig, make_lm_batches
from repro_torch.models import build_model
from repro_torch.models.transformer import from_jax_params
from repro_torch.train import Strategy, value_and_grad

torch.set_num_threads(2)

TOPOLOGIES = ("ring", "butterfly", "tree", "fully_connected", "psum")
METHODS = ("none", "onebit", "terngrad", "qsgd", "dgc")
N_EX, L_EX = 4, 1000


# ------------------------------------------------------------ byte models
@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_byte_models_match_jax(topology, n):
    for method in METHODS:
        port, ref = TCD.make_codec(method), JCD.make_codec(method)
        for length in (n * 64, n * 65, 4096, 12345, 1):
            assert TT.schedule_tx_bytes(topology, n, length, port) == \
                JT.schedule_tx_bytes(topology, n, length, ref)
        for size in (1.0, 4096.0, 123457.0):
            assert TT.per_device_bytes(topology, n, size) == \
                JT.per_device_bytes(topology, n, size)
    for length in (n * 64, 4096):
        assert TT.fp32_schedule_bytes(topology, n, length) == \
            JT.fp32_schedule_bytes(topology, n, length)
    for exact in (True, False):
        assert TT.model_error_factor(topology, n, exact) == \
            JT.model_error_factor(topology, n, exact)


def test_byte_model_stored_counterexample():
    """The reference misses its own 0.25 band at n=2, length=130 (onebit:
    34 B measured against 25 B predicted); the port reports the
    reference's 34 B, not the band."""
    for topo in ("ring", "butterfly"):
        port = TT.schedule_tx_bytes(topo, 2, 130, TCD.make_codec("onebit"))
        ref = JT.schedule_tx_bytes(topo, 2, 130, JCD.make_codec("onebit"))
        assert port == ref == 34


# ------------------------------------------------------ the JAX reference
_JAX_CHILD = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm.codecs import make_codec
from repro.comm.transport import compressed_allreduce_ef, pad_for_schedule
from repro.configs import get_config
from repro.core.collectives import shard_map
from repro.data import LMDataConfig, make_lm_batches
from repro.models import build_model
from repro.train import Strategy

out = {}
inp = np.load(%(inp)r)
x, ef = inp["x"], inp["ef"]
n, L = x.shape
mesh = Mesh(np.array(jax.devices()[:n]), ("w",))
Pl = pad_for_schedule(L, n)
for topo in %(topos)r:
    for method in ("none", "onebit", "dgc"):
        codec = make_codec(method, density=0.1) if method == "dgc" \
            else make_codec(method)
        gain = 2.0 if method == "onebit" else 1.0
        def body(xx, ee, kk, codec=codec, topo=topo, gain=gain):
            flat = jnp.pad(xx[0], (0, Pl - L))
            e = jnp.pad(ee[0], (0, Pl - L))
            red, new_e, sent = compressed_allreduce_ef(
                flat, e, "w", topo, codec, kk[0], gain=gain)
            return red[None], new_e[None], sent[None]
        f = jax.jit(shard_map(body, mesh=mesh,
                              in_specs=(P("w"), P("w"), P("w")),
                              out_specs=(P("w"), P("w"), P("w")),
                              check_vma=False))
        red, new_e, sent = f(x, ef, jax.random.split(jax.random.PRNGKey(1), n))
        key = topo + "/" + method
        out[key + "/red"] = np.asarray(red)
        out[key + "/ef"] = np.asarray(new_e)
        out[key + "/sent"] = np.asarray(sent)

from repro.comm.plan import CommPlan
from repro.core.compression import Compressor
psi = np.load(%(ps)r)
mesh4 = Mesh(np.array(jax.devices()[:4]), ("w",))
p_ex = [jnp.asarray(psi["p%%d" %% i]) for i in range(3)]
keys = jax.random.split(jax.random.PRNGKey(7), 4)
for method in ("onebit", "dgc", "terngrad", "qsgd"):
    comp = Compressor(method, density=0.1)
    plan = CommPlan.plan(p_ex, axis="w", n=4, compressor=comp,
                         wire="measured", bucket_mb=%(bucket_mb)r)
    ef_on = method in ("onebit", "dgc")
    def body(p, g, e, k, plan=plan, ef_on=ef_on):
        g = [x[0] for x in g]
        e = [x[0] for x in e] if ef_on else None
        new, ne, sent = plan.ps_exchange(p, g, e, k[0], 0.1)
        ne = [x[None] for x in ne] if ef_on else [x[None] for x in g]
        return [x[None] for x in new], ne, sent[None]
    f = jax.jit(shard_map(body, mesh=mesh4,
                          in_specs=(P(), P("w"), P("w"), P("w")),
                          out_specs=(P("w"), P("w"), P("w")),
                          check_vma=False))
    new, ne, sent = f(p_ex, [jnp.asarray(psi["g%%d" %% i]) for i in range(3)],
                      [jnp.asarray(psi["e%%d" %% i]) for i in range(3)], keys)
    for i in range(3):
        out["ps/%%s/p%%d" %% (method, i)] = np.asarray(new[i])
        out["ps/%%s/e%%d" %% (method, i)] = np.asarray(ne[i])
    out["ps/%%s/sent" %% method] = np.asarray(sent)
    # each hop's uniform draws, worker by worker, in bucket issue order
    draws = []
    for b in plan.order:
        m = pad_for_schedule(plan.bucket_len(b), 4) // 4
        rows = -(-m // 256)
        per_worker = []
        for w in range(4):
            kb = keys[w]
            for b2 in plan.order[:plan.order.index(b) + 1]:
                kb, sub = jax.random.split(kb)
            hops = []
            for i in range(3):
                sub, hk = jax.random.split(sub)
                hops.append(np.asarray(jax.random.uniform(hk, (rows, 256))))
            per_worker.append(hops)
        draws += [np.stack([per_worker[w][i] for w in range(4)])
                  for i in range(3)]
    for j, d in enumerate(draws):
        out["ps/%%s/u%%d" %% (method, j)] = d

cfg = get_config("tinyllama-1.1b").reduced()
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(0))
batches = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=16, batch_size=2))
def grad_fn(p, batch):
    (loss, _), g = jax.value_and_grad(
        lambda pp: model.loss_fn(pp, batch, compute_dtype=jnp.float32),
        has_aux=True)(p)
    return loss, g
for spec in %(specs)r:
    eng = Strategy.parse(spec, lr=0.01, bucket_mb=0.25, backend="device",
                         wire="measured").build(grad_fn)
    st = eng.init(params)
    losses, incs = [], []
    for t in range(2):
        before = st["wire"]
        st, ev = eng.step(st, batches, t)
        losses.append(ev[0]["loss"])
        incs.append(st["wire"] - before)
    m = eng.metrics()
    out[spec + "/losses"] = np.array(losses)
    out[spec + "/incs"] = np.array(incs)
    out[spec + "/tx"] = np.array([m["measured_step_tx_bytes"],
                                  m["fp32_step_tx_bytes"]])
np.savez(%(out)r, **out)
"""
ENGINE_SPECS = ("bsp/ring/onebit@8", "bsp/ring/dgc@8", "bsp/ps/onebit@8")
PS_SHAPES = ((40, 33), (257,), (3, 100))
PS_BUCKET_MB = 0.002               # two buckets over the PS_SHAPES leaves


def _exchange_inputs():
    rng = np.random.RandomState(0)
    x = (rng.standard_normal((N_EX, L_EX))
         * (1 + np.arange(N_EX))[:, None]).astype(np.float32)
    ef = (0.2 * rng.standard_normal((N_EX, L_EX))).astype(np.float32)
    return x, ef


def _ps_inputs():
    rng = np.random.RandomState(5)
    inp = {}
    for i, s in enumerate(PS_SHAPES):
        inp[f"p{i}"] = rng.standard_normal(s).astype(np.float32)
        # per-worker scales 1..4, so the codecs' per-worker statistics
        # differ from worker to worker
        inp[f"g{i}"] = (rng.standard_normal((4,) + s) * np.arange(
            1, 5).reshape((4,) + (1,) * len(s))).astype(np.float32)
        inp[f"e{i}"] = (0.2 * rng.standard_normal((4,) + s)).astype(
            np.float32)
    return inp


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_comm")
    x, ef = _exchange_inputs()
    np.savez(d / "inp.npz", x=x, ef=ef)
    np.savez(d / "ps.npz", **_ps_inputs())
    run_multidevice(_JAX_CHILD % dict(inp=str(d / "inp.npz"),
                                      ps=str(d / "ps.npz"),
                                      bucket_mb=PS_BUCKET_MB,
                                      topos=TOPOLOGIES, specs=ENGINE_SPECS,
                                      out=str(d / "out.npz")), n_devices=8)
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("method", ["none", "onebit", "dgc"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_compressed_exchange_matches_jax(jax_ref, topology, method):
    x, ef = _exchange_inputs()
    P = TT.pad_for_schedule(L_EX, N_EX)
    pad = lambda a: torch.nn.functional.pad(torch.from_numpy(a),
                                            (0, P - L_EX))
    codec = (TCD.make_codec("dgc", density=0.1) if method == "dgc"
             else TCD.make_codec(method))
    red, new_ef, sent = TT.compressed_allreduce_ef(
        pad(x), pad(ef), topology, codec,
        gain=2.0 if method == "onebit" else 1.0)
    key = f"{topology}/{method}"
    scale = float(np.abs(x.sum(0)).max())
    assert np.abs(red.numpy() - jax_ref[key + "/red"]).max() <= 1e-6 * scale
    assert np.abs(new_ef.numpy() - jax_ref[key + "/ef"]).max() <= \
        1e-6 * scale
    assert sent.tolist() == jax_ref[key + "/sent"].tolist()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_codec_schedule_consistent_and_telescoping(topology, method):
    """Every worker decodes the identical reduced vector, and reduced +
    the workers' residuals is the true sum (fp32 tolerance)."""
    x, _ = _exchange_inputs()
    codec = (TCD.make_codec("dgc", density=0.1) if method == "dgc"
             else TCD.make_codec(method))
    P = TT.pad_for_schedule(L_EX, N_EX)
    flat = torch.nn.functional.pad(torch.from_numpy(x), (0, P - L_EX))
    gen = torch.Generator().manual_seed(1)
    red, res, sent = TT.compressed_allreduce(flat.clone(), topology, codec,
                                             gen)
    assert red.shape == res.shape == (N_EX, P) and sent.shape == (N_EX,)
    red, res = red.numpy()[:, :L_EX], res.numpy()[:, :L_EX]
    assert np.max(np.abs(red - red[0])) == 0.0
    true = x.sum(0)
    gap = np.max(np.abs(red[0] + res.sum(0) - true)) / np.max(np.abs(true))
    assert gap < 1e-5, gap
    assert (sent.sum() > 0) == (method == "dgc")


def test_compressed_reduce_scatter_is_the_ring_half():
    x, ef = _exchange_inputs()
    P = TT.pad_for_schedule(L_EX, N_EX)
    flat = torch.nn.functional.pad(torch.from_numpy(x), (0, P - L_EX))
    e = torch.nn.functional.pad(torch.from_numpy(ef), (0, P - L_EX))
    codec = TCD.make_codec("onebit")
    shard, new_e, _ = TT.compressed_reduce_scatter_ef(flat.clone(), e,
                                                      codec, gain=2.0)
    m = P // N_EX
    assert shard.shape == (N_EX, m) and new_e.shape == (N_EX, P)
    # each worker's shard + every worker's next residual telescope to the
    # true compensated sum, chunk by chunk
    want = (flat + e).sum(0).reshape(N_EX, m)
    got = shard + new_e.sum(0).reshape(N_EX, m)
    assert (got - want).abs().max() / want.abs().max() < 1e-5


# ------------------------------------------- the parameter-server exchange
class _FedCodec:
    """A codec whose stochastic encodes take the given draws in order."""

    def __init__(self, codec, draws):
        self.codec, self.draws = codec, list(draws)

    def encode_ef(self, seg, gen=None, u=None):
        return self.codec.encode_ef(seg, gen, u=self.draws.pop(0))

    def __getattr__(self, name):
        return getattr(self.codec, name)


@pytest.mark.parametrize("method", ["onebit", "dgc", "terngrad", "qsgd"])
def test_ps_exchange_matches_jax(jax_ref, method):
    from repro_torch.comm.plan import CommPlan
    from repro_torch.core.compression import Compressor
    inp = {k: torch.from_numpy(v) for k, v in _ps_inputs().items()}
    plan = CommPlan.plan(PS_SHAPES, n=4, compressor=Compressor(
        method, density=0.1), wire="measured", bucket_mb=PS_BUCKET_MB)
    assert len(plan.buckets) == 2
    stochastic = method in ("terngrad", "qsgd")
    if stochastic:
        fed = _FedCodec(plan.codec, [
            torch.from_numpy(jax_ref[f"ps/{method}/u{j}"])
            for j in range(3 * len(plan.buckets))])
        plan.__class__ = type("FedPlan", (CommPlan,),
                              {"codec": property(lambda self: fed)})
    params = [inp[f"p{i}"] for i in range(3)]
    grads = [[inp[f"g{i}"][w] for i in range(3)] for w in range(4)]
    ef = (None if stochastic else
          [[inp[f"e{i}"][w] for i in range(3)] for w in range(4)])
    new, new_ef, sent = plan.ps_exchange(params, grads, ef, None, 0.1)
    if stochastic:
        assert not fed.draws                      # every draw consumed
    for i in range(3):
        ref = jax_ref[f"ps/{method}/p{i}"]
        assert np.abs(ref - ref[0]).max() == 0    # one pulled vector
        scale = float(np.abs(ref).max())
        assert np.abs(new[i].numpy() - ref[0]).max() <= 1e-6 * scale
        if not stochastic:
            ref_e = jax_ref[f"ps/{method}/e{i}"]
            got = np.stack([new_ef[w][i].numpy() for w in range(4)])
            assert np.abs(got - ref_e).max() <= 1e-6 * float(
                np.abs(ref_e).max())
    assert sent.tolist() == jax_ref[f"ps/{method}/sent"].tolist()
    assert (sent.sum() > 0) == (method == "dgc")
    assert all(g is None for w in grads for g in w)   # consumed as fused
    assert all(torch.equal(a, inp[f"p{i}"]) for i, a in enumerate(params))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ps_step_tx_bytes_match_jax(n):
    import jax.numpy as jnp
    from repro.comm.plan import CommPlan as JaxCommPlan
    from repro.core.compression import Compressor as JaxCompressor
    from repro_torch.comm.plan import CommPlan
    from repro_torch.core.compression import Compressor
    shapes = PS_SHAPES + ((n * 130 + 3,),)
    for method in METHODS:
        for wire in ("modeled", "measured"):
            kw = dict(n=n, wire=wire, bucket_mb=PS_BUCKET_MB)
            ref = JaxCommPlan.plan([jnp.zeros(s) for s in shapes],
                                   axis="w", compressor=JaxCompressor(method),
                                   **kw)
            plan = CommPlan.plan(shapes, compressor=Compressor(method), **kw)
            for arch in ("ps", "allreduce"):
                assert plan.measured_step_tx_bytes(arch) == \
                    ref.measured_step_tx_bytes(arch), (method, wire, arch)


# ------------------------------------------------------ the measured engine
def _reduced(seq_len=16, batch_size=2):
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = from_jax_params(cfg, jax.tree.map(np.array, jparams))
    model = build_model(cfg)
    batches = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=seq_len,
                                           batch_size=batch_size))
    grad_fn = value_and_grad(
        lambda p, b: model.loss_fn(p, b, compute_dtype=torch.float32))
    return model, params, batches, grad_fn


@pytest.mark.parametrize("spec", ENGINE_SPECS)
def test_measured_engine_matches_jax_engine(jax_ref, spec):
    model, params, batches, grad_fn = _reduced()
    eng = Strategy.parse(spec, lr=0.01, bucket_mb=0.25,
                         wire="measured").build(
        grad_fn, layout=model.leaf_layout(params), device="cpu")
    st = eng.init(params)
    losses, incs = [], []
    for t in range(2):
        before = st["wire"]
        st, ev = eng.step(st, batches, t)
        losses.append(ev[0]["loss"])
        incs.append(st["wire"] - before)
    m = eng.metrics()
    assert np.abs(np.array(losses) - jax_ref[spec + "/losses"]).max() <= 1e-4
    assert [m["measured_step_tx_bytes"], m["fp32_step_tx_bytes"]] == \
        jax_ref[spec + "/tx"].tolist()
    ref_incs = jax_ref[spec + "/incs"].tolist()
    assert incs[0] == ref_incs[0]
    print(f"{spec}: per-step wire {incs} (JAX {ref_incs})")
    if spec.endswith("onebit@8"):
        assert incs == ref_incs


# a linear regression whose gradients the schedules can be checked on
W_TRUE = np.random.RandomState(42).standard_normal((64, 1)).astype(
    np.float32)


def _lin_params():
    return {"W": torch.zeros(64, 1), "b": torch.zeros(8192)}


def _lin_batch(t, w, sparse_step0=False):
    X = np.random.RandomState(t * 100 + w).standard_normal(
        (16, 64)).astype(np.float32)
    if sparse_step0 and t == 0:
        X[:, 1:] = 0.0          # one active feature: mostly-zero gradient
    return {"X": torch.from_numpy(X), "y": torch.from_numpy(X @ W_TRUE)}


def _lin_loss(p, b):
    return ((b["X"] @ p["W"] - b["y"]) ** 2).mean(), {}


def _lin_engine(**kw):
    return Strategy(sync="bsp", workers=4, lr=0.05, **kw).build(
        value_and_grad(_lin_loss), device="cpu")


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_none_is_bitwise_equal_modeled_and_measured(topology):
    runs = {}
    for wire in ("modeled", "measured"):
        runs[wire] = _lin_engine(topology=topology, wire=wire).run(
            _lin_params(), _lin_batch, 3)
    for k in ("W", "b"):
        assert torch.equal(runs["modeled"][0][k], runs["measured"][0][k])
    assert [h["loss"] for h in runs["modeled"][1]] == \
        [h["loss"] for h in runs["measured"][1]]


def test_measured_wire_ordering():
    wires = {}
    for comp in ("onebit", "terngrad", "qsgd", "none"):
        _, hist, wires[comp] = _lin_engine(compression=comp,
                                           wire="measured").run(
            _lin_params(), _lin_batch, 4)
        assert all(np.isfinite(h["loss"]) for h in hist), comp
    assert wires["onebit"] < wires["terngrad"] < wires["qsgd"] < \
        wires["none"], wires


def test_dgc_measured_wire_follows_each_step():
    """Step 0's gradient is mostly exact zeros, so dgc's threshold
    degenerates and the sparse payload differs from the dense steps:
    measured bytes are counted per step, not cached from step 0."""
    eng = _lin_engine(compression="dgc", density=0.05, wire="measured")
    st = eng.init(_lin_params())
    incs, prev = [], 0
    for t in range(3):
        st, _ = eng.step(st, lambda s, w: _lin_batch(s, w, True), t)
        incs.append(st["wire"] - prev)
        prev = st["wire"]
    assert incs[0] != incs[1], incs
    assert incs[1] == incs[2] or abs(incs[1] - incs[2]) < incs[0], incs


def test_onebit_measured_acceptance_8_workers():
    """The JAX package's 8-device acceptance cell on the port:
    ``bsp/ring/onebit@8`` with ``wire="measured"``, reduced TinyLlama,
    seq 32, batch 4, 10 steps: at most 0.25x the fp32 ring's bytes and
    inside the loss band of the composition tests."""
    model, params, batches, grad_fn = _reduced(seq_len=32, batch_size=4)
    eng = Strategy.parse("bsp/ring/onebit@8", lr=0.01,
                         wire="measured").build(
        grad_fn, layout=model.leaf_layout(params), device="cpu")
    p_final, hist, _ = eng.run(params, batches, 10)
    m = eng.metrics()
    ratio_bytes = m["measured_step_tx_bytes"] / m["fp32_step_tx_bytes"]
    losses = [h["loss"] for h in hist]
    loss_ratio = (sum(losses[-3:]) / 3) / (sum(losses[:3]) / 3)
    print(f"bytes ratio {ratio_bytes:.4f}, loss ratio {loss_ratio:.5f}")
    assert ratio_bytes <= 0.25
    assert all(np.isfinite(x) for x in losses)
    assert loss_ratio < 1.001
    layout = model.leaf_layout(params)
    moved = max((a - b).abs().max().item() for a, b in zip(
        layout.leaves(p_final), layout.leaves(params)))
    assert moved > 0.0
