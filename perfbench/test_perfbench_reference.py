"""The plain references agree with the program (``repro_torch``) at a
reduced size on the CPU, and a run of each cell, cut to that size, comes
out correct against the cell's own limits."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import harness, port, tiny, weights
from perfbench.reference import exchange as X
from perfbench.reference import serve as ref_serve
from perfbench.reference import transformer as R
from perfbench.reference.transformer import weight_specs

CPU = torch.device("cpu")
SEED = 2 ** 31 + 71


def _cfg(name):
    man = harness.manifest()
    conf = {c["name"]: c for c in man["configs"]}[name]
    return tiny.config(harness.load_json(harness.ROOT / conf["file"]))


@pytest.mark.parametrize("name", ["stablelm-2-1.6b", "qwen2-vl-7b"])
def test_reference_loss_equals_the_programs(name):
    from repro_torch.models import build_model
    cfg = _cfg(name)
    W = weights.make(cfg, SEED, torch.float32, CPU)
    mcfg = port.model_config(cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg["vocab_size"], size=(1, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    prog, _ = build_model(mcfg).loss_fn(port.params(W, mcfg), batch,
                                        compute_dtype=torch.float32)
    ref = R.loss(W, cfg, batch["tokens"][0], batch["labels"][0])
    assert float(prog) == pytest.approx(float(ref), rel=1e-5)


def test_weights_are_made_again_one_at_a_time():
    cfg = _cfg("qwen2-vl-7b")
    W = weights.make(cfg, SEED, torch.bfloat16, CPU)
    for i, (name, _, _) in enumerate(weight_specs(cfg)):
        assert torch.equal(W[name], weights.make_one(cfg, SEED, i,
                                                     torch.bfloat16, CPU))


def test_reference_leaves_and_buckets_are_the_programs():
    from repro_torch.comm.plan import plan_buckets
    from repro_torch.models import build_model
    cfg = _cfg("stablelm-2-1.6b")
    W = weights.make(cfg, SEED, torch.float32, CPU)
    mcfg = port.model_config(cfg)
    params = port.params(W, mcfg)
    layout = build_model(mcfg).leaf_layout(params)
    leaves = X.leaf_order(cfg, list(W))
    mine = [[port.weight_name(p) for p in parts] for parts in layout.parts]
    assert mine == leaves
    shapes = layout.shapes(params)
    numels = [int(np.prod(s)) for s in shapes]
    for mb in (4.0, 1e-3, 0.05):
        want = plan_buckets(shapes, mb, "tictac", 2e-12, 0)[0]
        assert X.bucket_plan(numels, mb) == want


@pytest.mark.parametrize("method", ["onebit", "none"])
def test_reference_exchange_equals_the_programs(method):
    from repro_torch.comm.plan import CommPlan
    from repro_torch.core.compression import Compressor
    cfg = _cfg("stablelm-2-1.6b")
    names = [n for n, _, _ in weight_specs(cfg)]
    shapes = {n: s for n, s, _ in weight_specs(cfg)}
    leaves = X.leaf_order(cfg, names)
    lshapes = [(len(l),) + tuple(shapes[l[0]]) if len(l) > 1
               else tuple(shapes[l[0]]) for l in leaves]
    K, mb = 4, 0.01
    g = torch.Generator().manual_seed(3)
    grads = [{n: torch.randn(shapes[n], generator=g) for n in names}
             for _ in range(K)]
    plan = CommPlan.plan(lshapes, n=K, topology="ring",
                         compressor=Compressor(method), wire="measured",
                         bucket_mb=mb)
    prog_in = [[torch.stack([gr[n] for n in l]) if len(l) > 1 else gr[l[0]]
                for l in leaves] for gr in grads]
    ef_prog = ([[torch.zeros(s) for s in lshapes] for _ in range(K)]
               if method == "onebit" else None)
    ef_ref = {}
    buckets = X.bucket_plan([int(np.prod(s)) for s in lshapes], mb)
    for step in range(2):
        if method == "onebit":
            out, ef_prog, _ = plan.exchange([list(x) for x in prog_in],
                                            ef_prog)
        else:
            out = plan.reduce_grads([list(x) for x in prog_in])
        mean = X.exchange([dict(gr) for gr in grads], ef_ref, leaves, buckets,
                          method)
        for i, l in enumerate(leaves):
            got = out[i] if len(l) > 1 else out[i][None]
            for j, n in enumerate(l):
                torch.testing.assert_close(mean[n], got[j], rtol=1e-5,
                                           atol=1e-6)


def test_reference_reads_greedy_served_tokens_near_zero():
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.models import build_model
    from repro_torch.serve.request import Request
    cfg = _cfg("qwen2-vl-7b")
    W = weights.make(cfg, SEED, torch.float32, CPU)
    mcfg = port.model_config(cfg)
    eng = ServeEngine(build_model(mcfg), port.params(W, mcfg),
                      ServeConfig(slots=2, max_len=32, page_size=4), device=CPU)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg["vocab_size"], size=n) for n in (9, 14)]
    reqs = [Request(rid=i, prompt=p.tolist(), max_new_tokens=6)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    served = [(p, r.output) for p, r in zip(prompts, reqs)]
    widest, n = ref_serve.gaps(W, cfg, served, CPU)
    assert n == 12 and widest < 1e-4
    # a wrong token reads the distance to the best one
    bad = [(prompts[0], [(t + 1) % cfg["vocab_size"] for t in reqs[0].output])]
    assert ref_serve.gaps(W, cfg, bad, CPU)[0] > 1e-3


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.manifest()["workloads"]])
def test_a_reduced_run_of_each_cell_is_correct(workload):
    c = tiny.cell(workload)
    res = harness.run_cell(c, SEED, 0.3, False, CPU, 0.0)
    assert res.correct, res.checks
    assert res.attempted > 0
    line = harness.result_line(c, res, False, CPU)
    assert list(line)[-1] == "checks"
    assert {m["name"] for m in c.end_to_end} == set(line["metrics"])
