"""How closely the port's trainer follows the JAX package's, past the
tolerances its tests hold (CPU, reduced TinyLlama, JAX-initialised).

  PYTHONPATH=src python tools/torch_trainer_parity.py

Prints the share of ``jax.lax.rsqrt`` values on the CPU that are
correctly rounded; for the SGD and Adam cases of the optimizer tests on
reduced-TinyLlama gradient leaves, the elements that differ at all; for
Adafactor (at its case's lr 0.2) the parameters' elementwise misses of
rtol 1e-5, their error against the distance each weight travelled, and
its state's worst elementwise relative error; and for
``bsp/allreduce/onebit@2`` through ``make_sharded_train_step`` (AdamW,
batch 2 x seq 32 per worker), after each of 3 steps, the rows of the
onebit plane in which a worker's EF is off the JAX package's by more
than 1e-5 of the leaf's largest residual, with the elements in each such
row that moved by more than half the row's mean residual (a sign flip's
own element): in the run, and in one step taken from the JAX package's
state at the step's start.  The setups are the tests'
(``tests/test_torch_optim.py``, ``tests/test_torch_train_step.py``).
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax                                        # noqa: E402
import jax.numpy as jnp                           # noqa: E402
import torch                                      # noqa: E402

import test_torch_optim as O                      # noqa: E402
import test_torch_train_step as S                 # noqa: E402
from conftest import run_multidevice              # noqa: E402


def misses(a, b, rtol=1e-5):
    return int((np.abs(a - b) > rtol * np.abs(b)).sum())


def rsqrt_rounding():
    """The share of ``jax.lax.rsqrt`` values on this CPU that are the
    correctly rounded 1/sqrt(x) (the float64 value rounded to fp32)."""
    x = np.abs(np.random.RandomState(0).standard_normal(100000)).astype(
        np.float32) + np.float32(1e-6)
    got = np.asarray(jax.lax.rsqrt(jnp.asarray(x)))
    exact = (1 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    print(f"jax.lax.rsqrt correctly rounded in "
          f"{(got == exact).mean():.4f} of 100000 values")


def exact_cases():
    """The other model-leaf cases: elements of parameters and state that
    differ from the JAX package's at all after 5 steps at each case's lr."""
    s = O._model_setup()
    for name, jo, to, lr in O.MODEL_CASES:
        if name == "adafactor":
            continue
        jp = jax.tree.map(jnp.asarray, s["jparams"])
        tp = O.from_jax_params(s["cfg"], s["jparams"])
        layout = s["model"].leaf_layout(tp)
        js, ts = jo.init(jp), to.init(tp, layout=layout)
        for jg in s["jgrads"]:
            jp, js = jo.step(jp, jax.tree.map(jnp.asarray, jg), js, lr)
            to.step(tp, O.from_jax_params(s["cfg"], jg), ts, lr,
                    layout=layout)
        pairs = list(zip([a.numpy() for a in layout.leaves(tp)],
                         [np.asarray(b) for b in jax.tree.leaves(jp)]))
        pairs += list(zip(O._state_leaves(name, ts, layout),
                          O._state_leaves(name, js)))
        print(f"{name}, 5 steps at lr {lr}: "
              f"{sum(int((a != b).sum()) for a, b in pairs)} of "
              f"{sum(a.size for a, _ in pairs)} parameter and state "
              f"elements differ")


def adafactor():
    _, jo, to, lr = [c for c in O.MODEL_CASES if c[0] == "adafactor"][0]
    s = O._model_setup()
    jp = jax.tree.map(jnp.asarray, s["jparams"])
    tp = O.from_jax_params(s["cfg"], s["jparams"])
    layout = s["model"].leaf_layout(tp)
    js, ts = jo.init(jp), to.init(tp, layout=layout)
    travel = [np.zeros(np.shape(b), np.float32) for b in jax.tree.leaves(jp)]
    for jg in s["jgrads"]:
        before = [np.asarray(b) for b in jax.tree.leaves(jp)]
        jp, js = jo.step(jp, jax.tree.map(jnp.asarray, jg), js, lr)
        to.step(tp, O.from_jax_params(s["cfg"], jg), ts, lr, layout=layout)
        travel = [d + np.abs(np.asarray(b) - b0) for d, b, b0
                  in zip(travel, jax.tree.leaves(jp), before)]
    pairs = [(a.numpy(), np.asarray(b))
             for a, b in zip(layout.leaves(tp), jax.tree.leaves(jp))]
    state = zip(O._state_leaves("adafactor", ts, layout),
                O._state_leaves("adafactor", js))
    miss = [np.abs(a - b) > 1e-5 * np.abs(b) for a, b in pairs]
    print(f"adafactor, 5 steps at lr {lr}: weights missing rtol 1e-5 "
          f"{sum(int(m.sum()) for m in miss)} of "
          f"{sum(a.size for a, _ in pairs)} (the largest such |weight| "
          f"{max(np.abs(b)[m].max() for (_, b), m in zip(pairs, miss) if m.any()):.3e}); "
          f"largest |error| "
          f"{max(np.abs(a - b).max() for a, b in pairs):.3e}; worst error "
          f"over the distance travelled "
          f"{max((np.abs(a - b)[d > 0] / d[d > 0]).max() for (a, b), d in zip(pairs, travel)):.3e}; "
          f"state's worst elementwise relative error "
          f"{max((np.abs(a - b) / np.abs(b)).max() for a, b in state):.3e}")


def _rows_off(ef, ref, comp):
    """(rows of the onebit plane off by more than 1e-5 of the leaf's
    largest residual, and in each such row the elements off by more than
    half the row's mean |residual|: a sign flip's own element)."""
    rows, jumps = 0, []
    for e, r in zip(ef, ref):
        width = S._channel_axis(r.shape[1:], comp.min_channel) or 256
        for w in range(len(r)):
            d = np.abs(e[w].numpy() - r[w]).ravel()
            rr = np.abs(r[w]).ravel()
            pad = (0, -d.size % width)
            d = np.pad(d, pad).reshape(-1, width)
            rr = np.pad(rr, pad).reshape(-1, width)
            off = (d > 1e-5 * rr.max()).any(-1)
            rows += int(off.sum())
            jumps += [int((d[i] > 0.5 * rr[i].mean()).sum())
                      for i in np.flatnonzero(off)]
    return rows, jumps


def sharded_ef():
    s = S.setup()
    model, params = s["model"], s["params"]
    out = os.path.join(ROOT, "build", "trainer_parity.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    run_multidevice(S._SHARDED_CHILD % dict(
        K=S.K_WORKERS, seq=S.K_SEQ, batch=S.K_BATCH, methods=("onebit",),
        bucket_mb=S.K_BUCKET_MB, sched=S.K_SCHEDULE, steps=S.K_STEPS,
        out=out), n_devices=S.K_WORKERS)
    ref = dict(np.load(out))
    layout = model.leaf_layout(params)
    comp, opt = S.Compressor("onebit"), S.OPTIMIZERS["adamw"]()
    step = S.make_train_step(
        model.loss_fn, opt, S.cosine_warmup(*S.K_SCHEDULE), precision=S.FP32,
        compressor=comp, layout=layout,
        reduce_fn=S.make_bucketed_allreduce(
            params, bucket_mb=S.K_BUCKET_MB, layout=layout))
    state = S.TrainState.create(params, opt, comp, layout)
    state["ef"] = [torch.zeros((S.K_WORKERS,) + e.shape) for e in state["ef"]]
    sharded = S.make_sharded_train_step(step, S.K_WORKERS, compressed=True)
    batches = S.make_lm_batches(S.LMDataConfig(
        vocab_size=s["cfg"].vocab_size, seq_len=S.K_SEQ,
        batch_size=S.K_BATCH))
    stacked = lambda t: S.tree_map(lambda *xs: torch.stack(xs), *[
        batches(t, w) for w in range(S.K_WORKERS)])
    n_rows = sum(-(-e[0].numel() // (S._channel_axis(e.shape[1:],
                                                     comp.min_channel)
                                     or 256)) * len(e) for e in state["ef"])
    for t in range(S.K_STEPS):
        refs = [ref[f"onebit/ef{t}/{i}"] for i in range(len(state["ef"]))]
        state, mets = sharded(state, stacked(t))
        rows, jumps = _rows_off(state["ef"], refs, comp)
        st = S._jax_state(ref, "onebit", t, s["cfg"], s["jparams"])
        st, m2 = sharded(st, stacked(t))
        rows2, jumps2 = _rows_off(st["ef"], refs, comp)
        print(f"onebit@2 step {t + 1}: codec rows whose EF is off by more "
              f"than 1e-5 of the leaf's largest residual, of {n_rows}: "
              f"{rows} in the run (flipped elements per row {jumps[:8]}), "
              f"{rows2} from the reference's state (flipped {jumps2[:8]}); "
              f"|loss - JAX's| {abs(float(mets['loss']) - ref['onebit/loss'][t]):.2e} "
              f"and {abs(float(m2['loss']) - ref['onebit/loss'][t]):.2e}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    rsqrt_rounding()
    exact_cases()
    adafactor()
    sharded_ef()
