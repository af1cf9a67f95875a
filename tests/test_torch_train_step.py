"""The port's trainer against the JAX package's, on the CPU: reduced
TinyLlama with the JAX init's weights (``from_jax_params``), fp32.

* ``make_train_step`` on one worker, batch 8 x seq 64, 4 steps of
  ``cosine_warmup``: Adam and AdamW x none, onebit and dgc:0.05, each
  step's loss within 1e-4 of the reference's and ``wire_bytes`` exactly
  equal.  ``remat=True`` gives the losses of ``remat=False``.  terngrad
  and qsgd descend over the 4 steps (their draws cannot follow JAX's
  PRNG), and ``wire_bytes`` wraps modulo 2**31 - 1 as the reference's
  int32 does (a stub compressor's byte count).
* ``make_sharded_train_step`` over ``make_bucketed_allreduce`` against the
  reference's under ``shard_map`` on 2 virtual devices (one
  ``run_multidevice`` subprocess): ``bsp/allreduce/{none,onebit}@2`` with
  AdamW(0.01), 3 steps of batch 2 x seq 32 per worker: losses within
  1e-4, the fused buckets and their issue order equal, and each worker's
  EF within 1e-5 of the leaf's largest residual in all but at most 2
  rows of the onebit plane per step (one sign flip near zero moves its
  row's bin means): after steps 1 and 2 of the run, and after each step
  taken again from the reference's own state at its start.
* ``launch/train.py``'s ``build`` against the reference launcher's body for
  ``--smoke --steps 3``: the JSON lines' losses within 1e-4, the lr within
  one fp32 ulp of the reference's (jitted) values, ``wire_bytes`` equal;
  ``main`` raises without a card and runs with ``--device cpu``.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from conftest import run_multidevice
from repro.configs import get_config as jax_get_config
from repro.core.compression import Compressor as JaxCompressor
from repro.core.precision import PrecisionPolicy as JaxPrecisionPolicy
from repro.data import LMDataConfig as JaxLMDataConfig
from repro.data import make_lm_batches as jax_make_lm_batches
from repro.models import build_model as jax_build_model
from repro.optim import OPTIMIZERS as JAX_OPTIMIZERS
from repro.optim.schedule import cosine_warmup as jax_cosine_warmup
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro.train import train_loop as jax_train_loop
from repro_torch.configs import get_config
from repro_torch.core.compression import Compressor, _channel_axis
from repro_torch.core.precision import FP32, PrecisionPolicy
from repro_torch.core.tree import tree_map
from repro_torch.data import LMDataConfig, make_lm_batches
from repro_torch.launch import train as launcher
from repro_torch.models import build_model
from repro_torch.models.transformer import from_jax_params
from repro_torch.optim import OPTIMIZERS
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.train import (TrainState, make_bucketed_allreduce,
                               make_sharded_train_step, make_train_step,
                               train_loop)

torch.set_num_threads(2)

STEPS, BATCH, SEQ = 4, 8, 64
SCHEDULE = (3e-3, 1, STEPS)          # peak, warm-up, total
_CACHE = {}


def setup():
    if not _CACHE:
        jcfg = jax_get_config("tinyllama-1.1b").reduced()
        cfg = get_config("tinyllama-1.1b").reduced()
        jmodel, model = jax_build_model(jcfg), build_model(cfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        params = from_jax_params(cfg, jax.tree.map(np.array, jparams))
        _CACHE.update(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model,
                      jparams=jparams, params=params)
    return _CACHE


def _compressor(cls, method):
    return cls(method, density=0.05) if method == "dgc" else cls(method)


def _jax_run(opt_name, method, steps=STEPS, batch=BATCH, seq=SEQ,
             schedule=SCHEDULE, compressor=None):
    s = setup()
    opt = JAX_OPTIMIZERS[opt_name]()
    comp = compressor or _compressor(JaxCompressor, method)
    step = jax_make_train_step(
        s["jmodel"].loss_fn, opt, jax_cosine_warmup(*schedule),
        precision=JaxPrecisionPolicy(compute_dtype="float32"),
        compressor=comp)
    batches = jax_make_lm_batches(JaxLMDataConfig(
        vocab_size=s["jcfg"].vocab_size, seq_len=seq, batch_size=batch))
    _, hist = jax_train_loop(step, JaxTrainState.create(s["jparams"], opt,
                                                        comp),
                             lambda t: batches(t, 0), steps, log_every=1)
    return hist


def _port_run(opt_name, method, steps=STEPS, remat=False, compressor=None):
    s = setup()
    model, params = s["model"], s["params"]
    layout = model.leaf_layout(params)
    opt = OPTIMIZERS[opt_name]()
    comp = compressor or _compressor(Compressor, method)
    step = make_train_step(model.loss_fn, opt, cosine_warmup(*SCHEDULE),
                           precision=PrecisionPolicy(compute_dtype="float32"),
                           compressor=comp, remat=remat, layout=layout)
    batches = make_lm_batches(LMDataConfig(
        vocab_size=s["cfg"].vocab_size, seq_len=SEQ, batch_size=BATCH))
    _, hist = train_loop(step, TrainState.create(params, opt, comp, layout),
                         lambda t: batches(t, 0), steps, log_every=1)
    return hist


# ------------------------------------------------------------ one worker
@pytest.mark.parametrize("method", ["none", "onebit", "dgc"])
@pytest.mark.parametrize("opt_name", ["adam", "adamw"])
def test_train_step_matches_jax(opt_name, method):
    ref = _jax_run(opt_name, method)
    port = _port_run(opt_name, method)
    assert len(port) == len(ref) == STEPS
    for a, b in zip(port, ref):
        assert abs(a["loss"] - b["loss"]) <= 1e-4, (a["step"], a, b)
        assert a["wire_bytes"] == b["wire_bytes"]
        assert abs(a["lr"] - b["lr"]) <= np.spacing(np.float32(b["lr"]))
    assert (port[0]["wire_bytes"] == 0) == (method == "none")


def test_remat_gives_the_same_losses():
    plain = _port_run("adam", "onebit")
    remat = _port_run("adam", "onebit", remat=True)
    assert [h["loss"] for h in remat] == [h["loss"] for h in plain]


@pytest.mark.parametrize("method", ["terngrad", "qsgd"])
def test_stochastic_compressors_descend(method):
    hist = _port_run("adam", method)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"], [h["loss"] for h in hist]
    assert hist[0]["wire_bytes"] > 0


@dataclasses.dataclass(frozen=True)
class _StubCompressor(Compressor):
    """Passes gradients through and reports more bytes than int32 holds."""
    def roundtrip(self, grads, state, gen=None):
        return list(grads), state, 2**31 + 5


@dataclasses.dataclass(frozen=True)
class _JaxStubCompressor(JaxCompressor):
    def roundtrip(self, grads, state, rng=None):
        return grads, state, 2**31 + 5


def test_wire_bytes_wrap_like_int32():
    port = _port_run("adam", None, steps=1,
                     compressor=_StubCompressor("qsgd"))
    ref = _jax_run("adam", None, steps=1,
                   compressor=_JaxStubCompressor("qsgd"))
    assert port[0]["wire_bytes"] == ref[0]["wire_bytes"] == 6


# -------------------------------------------------------------- K workers
_SHARDED_CHILD = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.core.compression import Compressor
from repro.core.precision import PrecisionPolicy
from repro.data import LMDataConfig, make_lm_batches
from repro.models import build_model
from repro.optim import AdamW
from repro.optim.schedule import cosine_warmup
from repro.train import (TrainState, make_bucketed_allreduce,
                         make_sharded_train_step, make_train_step, train_loop)
from repro.train.data_parallel import AXIS

K = %(K)d
cfg = get_config("tinyllama-1.1b").reduced()
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(0))
batches = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=%(seq)d, batch_size=%(batch)d))
out = {}
for method in %(methods)r:
    comp = Compressor(method)
    opt = AdamW(0.01)
    reduce_fn = make_bucketed_allreduce(params, topology="ring",
                                        bucket_mb=%(bucket_mb)r,
                                        order="tictac")
    step = make_train_step(model.loss_fn, opt, cosine_warmup(*%(sched)r),
                           precision=PrecisionPolicy(compute_dtype="float32"),
                           compressor=comp, reduce_fn=reduce_fn)
    state = TrainState.create(params, opt, comp)
    if state["ef"] is not None:
        state["ef"] = jax.tree.map(
            lambda x: jnp.zeros((K,) + x.shape, x.dtype), state["ef"])
    mesh = Mesh(np.array(jax.devices()[:K]), (AXIS,))
    sharded = make_sharded_train_step(step, mesh,
                                      compressed=state["ef"] is not None)
    def stacked(t):
        per = [batches(t, w) for w in range(K)]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *per)
    # train_loop(sharded, ..., jit=False) step by step, to keep the EF
    # after each step
    rng, losses, wires = jax.random.PRNGKey(0), [], []
    for t in range(%(steps)d):
        if state["ef"] is not None:
            # the state each step starts from: params, moments and EF
            for name, tree in (("p", state["params"]),
                               ("m", state["opt_state"]["m"]),
                               ("v", state["opt_state"]["v"]),
                               ("e", state["ef"])):
                for i, x in enumerate(jax.tree.leaves(tree)):
                    out[method + "/in%%d/%%s%%d" %% (t, name, i)] = \
                        np.asarray(x)
        rng, sub = jax.random.split(rng)
        state, mets = sharded(state, stacked(t), sub)
        losses.append(float(mets["loss"]))
        wires.append(float(mets["wire_bytes"]))
        if state["ef"] is not None:
            for i, e in enumerate(jax.tree.leaves(state["ef"])):
                out[method + "/ef%%d/%%d" %% (t, i)] = np.asarray(e)
    out[method + "/loss"] = np.array(losses)
    out[method + "/wire"] = np.array(wires)
    out[method + "/order"] = np.array(reduce_fn.order)
    out[method + "/fused"] = np.array([(f.grad_bytes, f.back_compute_s)
                                       for f in reduce_fn.fused_layers])
np.savez(%(out)r, **out)
"""
K_WORKERS, K_STEPS, K_BATCH, K_SEQ, K_BUCKET_MB = 2, 3, 2, 32, 0.25
K_SCHEDULE = (3e-3, 1, K_STEPS)
K_METHODS = ("none", "onebit")


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_sharded") / "out.npz"
    run_multidevice(_SHARDED_CHILD % dict(
        K=K_WORKERS, seq=K_SEQ, batch=K_BATCH, methods=K_METHODS,
        bucket_mb=K_BUCKET_MB, sched=K_SCHEDULE, steps=K_STEPS,
        out=str(out)), n_devices=K_WORKERS)
    return dict(np.load(out))


def _ef_rows_off(ef, ref, comp):
    """Rows of the onebit plane (the codec's ``[rows, width]`` view of a
    leaf), over every leaf and worker, in which the port's EF is off the
    reference's by more than 1e-5 of the leaf's largest residual."""
    rows = 0
    for e, r in zip(ef, ref):
        width = _channel_axis(r.shape[1:], comp.min_channel) or 256
        for w in range(len(r)):
            off = np.abs(e[w].numpy() - r[w]) > 1e-5 * np.abs(r[w]).max()
            off = np.pad(off.ravel(), (0, -off.size % width))
            rows += int(off.reshape(-1, width).any(-1).sum())
    return rows


def _jax_state(ref, method, t, cfg, jparams):
    """The port's train state from the reference's at the start of step
    ``t`` (its saved params, Adam moments and stacked EF)."""
    treedef = jax.tree.structure(jparams)
    n = treedef.num_leaves
    tree = lambda k: from_jax_params(cfg, jax.tree.unflatten(
        treedef, [ref[f"{method}/in{t}/{k}{i}"] for i in range(n)]))
    ef = [torch.from_numpy(ref[f"{method}/in{t}/e{i}"].copy())
          for i in range(n)]
    return dict(params=tree("p"),
                opt_state={"m": tree("m"), "v": tree("v"), "t": t},
                step=t, ef=ef)


# a sign flip of one element of c = g + e near zero, where the two
# packages' gradients differ in their last bits, moves the two bin means
# of its one codec row: at most this many rows per step
EF_ROWS_MOVED = 2


@pytest.mark.parametrize("method", K_METHODS)
def test_sharded_step_matches_jax(jax_sharded, method):
    ref = jax_sharded
    s = setup()
    model, params = s["model"], s["params"]
    layout = model.leaf_layout(params)
    comp, opt = Compressor(method), OPTIMIZERS["adamw"]()
    reduce_fn = make_bucketed_allreduce(params, topology="ring",
                                        bucket_mb=K_BUCKET_MB, order="tictac",
                                        layout=layout)
    assert reduce_fn.order == list(ref[method + "/order"])
    assert [(f.grad_bytes, f.back_compute_s)
            for f in reduce_fn.fused_layers] == \
        [tuple(x) for x in ref[method + "/fused"].tolist()]
    step = make_train_step(model.loss_fn, opt, cosine_warmup(*K_SCHEDULE),
                           precision=FP32, compressor=comp,
                           reduce_fn=reduce_fn, layout=layout)
    state = TrainState.create(params, opt, comp, layout)
    if state["ef"] is not None:
        state["ef"] = [torch.zeros((K_WORKERS,) + e.shape)
                       for e in state["ef"]]
    sharded = make_sharded_train_step(step, K_WORKERS,
                                      compressed=state["ef"] is not None)
    batches = make_lm_batches(LMDataConfig(
        vocab_size=s["cfg"].vocab_size, seq_len=K_SEQ, batch_size=K_BATCH))

    def stacked(t):
        per = [batches(t, w) for w in range(K_WORKERS)]
        return tree_map(lambda *xs: torch.stack(xs), *per)

    hist = []
    for t in range(K_STEPS):
        state, h = train_loop(sharded, state, lambda _: stacked(t), 1)
        hist += h
        if method == "none":
            assert state["ef"] is None
        elif t < 2:
            # the EF each worker carries out of steps 1 and 2 (step 1 runs
            # at lr 0, so step 2 starts from the reference's parameters)
            rows = _ef_rows_off(state["ef"], [
                ref[f"{method}/ef{t}/{i}"] for i in range(len(state["ef"]))],
                comp)
            assert rows <= EF_ROWS_MOVED, (t, rows)
    losses = np.array([h["loss"] for h in hist])
    assert np.abs(losses - ref[method + "/loss"]).max() <= 1e-4
    np.testing.assert_array_equal([h["wire_bytes"] for h in hist],
                                  ref[method + "/wire"])
    if method == "none":
        return
    # from step 3 on the two runs' parameters differ by step 2's moved
    # rows: each step again from the reference's own state, so the EF
    # carried in is the reference's and the EF carried out is held
    for t in range(K_STEPS):
        st = _jax_state(ref, method, t, s["cfg"], s["jparams"])
        st, mets = sharded(st, stacked(t))
        assert abs(float(mets["loss"]) - ref[method + "/loss"][t]) <= 1e-4
        rows = _ef_rows_off(st["ef"], [
            ref[f"{method}/ef{t}/{i}"] for i in range(len(st["ef"]))], comp)
        assert rows <= EF_ROWS_MOVED, (t, rows)


def test_sharded_step_needs_reduce_fn():
    s = setup()
    step = make_train_step(s["model"].loss_fn, OPTIMIZERS["adam"]())
    with pytest.raises(ValueError, match="reduce_fn"):
        make_sharded_train_step(step, 2, compressed=False)


# --------------------------------------------------------------- launcher
def _jax_launcher(argv):
    """The reference launcher's body (``repro.launch.train.main``) for a
    decoder-only config, with its flags' defaults."""
    args = launcher.parse_args(argv + ["--device", "cpu"])
    s = setup()
    opt = JAX_OPTIMIZERS[args.optimizer]()
    comp = JaxCompressor(args.compress)
    batches = jax_make_lm_batches(JaxLMDataConfig(
        vocab_size=s["jcfg"].vocab_size, seq_len=args.seq_len,
        batch_size=args.batch_size))
    step = jax_make_train_step(
        s["jmodel"].loss_fn, opt, jax_cosine_warmup(args.lr, 5, args.steps),
        precision=JaxPrecisionPolicy(compute_dtype=args.compute_dtype),
        compressor=comp)
    _, hist = jax_train_loop(step, JaxTrainState.create(s["jparams"], opt,
                                                        comp),
                             lambda t: batches(t, 0), args.steps,
                             log_every=max(1, args.steps // 10))
    return hist


@pytest.mark.parametrize("compress", ["none", "onebit"])
def test_launcher_matches_jax(compress):
    argv = ["--smoke", "--steps", "3", "--compress", compress]
    ref = _jax_launcher(argv)
    run = launcher.build(launcher.parse_args(argv + ["--device", "cpu"]),
                         params=setup()["params"])
    _, hist = launcher.train(run)
    lines = [json.loads(x) for x in launcher.json_lines(hist)]
    ref_lines = [json.loads(x) for x in launcher.json_lines(ref)]
    assert [x["step"] for x in lines] == [x["step"] for x in ref_lines] == \
        [0, 1, 2]
    for a, b in zip(lines, ref_lines):
        assert abs(a["loss"] - b["loss"]) <= 1e-4
        assert a["wire_bytes"] == b["wire_bytes"]
    for a, b in zip(hist, ref):
        assert abs(a["lr"] - b["lr"]) <= np.spacing(np.float32(b["lr"]))
        assert a["wire_bytes"] == b["wire_bytes"]


def test_launcher_main_needs_a_card_unless_told(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the host without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--smoke", "--steps", "1"])
    hist = launcher.main(["--smoke", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [json.loads(x)["step"] for x in out[:2]] == [0, 1]
    assert out[2].startswith("done in") and len(hist) == 2
    assert all(np.isfinite(h["loss"]) for h in hist)
