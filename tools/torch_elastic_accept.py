"""PR 20's run-3 elastic scenario through both packages at ``.reduced()``
on the CPU: ``ssp:2/ring/onebit@4`` under ``crash:w2@5,resize:4@10``, 15
steps, checkpoints every 3, SGD lr 0.01, each data stream repeating its
first batch (the run that missed ``chip_smoke.py`` phase 17d's bound).

  PYTHONPATH=src python tools/torch_elastic_accept.py

Reduced TinyLlama with the JAX package's ``PRNGKey(0)`` init (the port
gets the same weights), batch 2 x 32 per stream.  Runs ``repro``'s
simulator (snapshots written in the foreground: its background writes
can mix two steps, ROADMAP queue C) and the port's device engine and
simulator, each uninterrupted and under the plan, and prints each run's
first and last loss, the plan run's last loss over the uninterrupted
one against the 4x bound, and how far the port's device engine's losses
stay from ``repro``'s event by event.
"""
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax                                        # noqa: E402
import jax.numpy as jnp                           # noqa: E402
import torch                                      # noqa: E402

from repro.configs import get_config as jax_get_config      # noqa: E402
from repro.data import LMDataConfig as JaxLMDataConfig      # noqa: E402
from repro.data import make_lm_batches as jax_make_lm_batches  # noqa: E402
from repro.elastic import recovery as jax_recovery          # noqa: E402
from repro.models import build_model as jax_build_model     # noqa: E402
from repro.train import Strategy as JaxStrategy             # noqa: E402
from repro.train import Trainer as JaxTrainer               # noqa: E402
from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.data import LMDataConfig, make_lm_batches  # noqa: E402
from repro_torch.models import build_model                  # noqa: E402
from repro_torch.models.transformer import from_jax_params  # noqa: E402
from repro_torch.train import Strategy, Trainer, value_and_grad  # noqa: E402

SPEC, PLAN, STEPS, EVERY, LR = ("ssp:2/ring/onebit@4",
                                "crash:w2@5,resize:4@10", 15, 3, 0.01)
SEQ, BATCH = 32, 2


def main():
    torch.set_num_threads(4)
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = from_jax_params(cfg, jax.tree.map(np.array, jparams))

    def jax_grad(p, batch):
        (loss, _), g = jax.value_and_grad(
            lambda pp: jmodel.loss_fn(pp, batch, compute_dtype=jnp.float32),
            has_aux=True)(p)
        return loss, g

    jb = jax_make_lm_batches(JaxLMDataConfig(vocab_size=jcfg.vocab_size,
                                             seq_len=SEQ, batch_size=BATCH))
    pb = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=SEQ, batch_size=BATCH))
    jfixed = [jb(0, w) for w in range(4)]
    pfixed = [pb(0, w) for w in range(4)]
    save = jax_recovery.save_engine_state
    jax_recovery.save_engine_state = lambda *a, **k: save(
        *a, **dict(k, background=False))
    grad = value_and_grad(lambda p, b: model.loss_fn(
        p, b, compute_dtype=torch.float32))
    layout = model.leaf_layout(params)
    runs = {}
    for who in ("repro sim", "port device", "port sim"):
        for plan in (None, PLAN):
            with tempfile.TemporaryDirectory() as d:
                kw = {} if plan is None else dict(
                    plan=plan, checkpoint_dir=d, checkpoint_every=EVERY)
                if who == "repro sim":
                    _, hist, mets = JaxTrainer(JaxStrategy.parse(
                        SPEC, lr=LR, backend="sim")).fit(
                        jax_grad, jparams, lambda t, w: jfixed[w], STEPS,
                        **kw)
                else:
                    _, hist, mets = Trainer(Strategy.parse(
                        SPEC, lr=LR, backend=who.split()[1]),
                        device="cpu").fit(
                        grad, params, lambda t, w: pfixed[w], STEPS,
                        layout=layout, **kw)
            runs[who, plan] = hist
            print(f"{who:12s} {plan or 'uninterrupted':24s} events "
                  f"{len(hist):3d}; loss first {hist[0]['loss']:.6f} "
                  f"last {hist[-1]['loss']:.6f}"
                  + ("" if plan is None else
                     f"; recoveries {len(mets['recoveries'])}, resizes "
                     f"{mets['resizes']}, final_workers "
                     f"{mets['final_workers']}"), flush=True)
        lu, le = runs[who, None][-1]["loss"], runs[who, PLAN][-1]["loss"]
        print(f"{who}: plan / uninterrupted last loss {le / lu:.3f} "
              f"(bound 4): {'meets' if le <= 4 * lu else 'misses'} it")
    for plan in (None, PLAN):
        a, b = runs["repro sim", plan], runs["port device", plan]
        gaps = [abs(x["loss"] - y["loss"]) for x, y in zip(a, b)]
        first = {tol: next((i for i, g in enumerate(gaps) if g > tol), None)
                 for tol in (1e-4, 1e-3, 1e-2)}
        print(f"port device against repro sim, {plan or 'uninterrupted'}: "
              f"{len(a)} / {len(b)} events, largest loss gap "
              f"{max(gaps):.3e}; first event past 1e-4 / 1e-3 / 1e-2: "
              f"{first[1e-4]} / {first[1e-3]} / {first[1e-2]}")


if __name__ == "__main__":
    main()
