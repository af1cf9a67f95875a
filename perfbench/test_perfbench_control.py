"""The controls of the correctness check, at a size a CPU test can hold:
the reference computed one precision below the configuration's, put in
the program's place, reads far more than the program does and comes out
not correct at the cell's own limits.  (The limits
themselves are set from the same readings on the card at each cell's own
size: ``perfbench/controls.py``, ``PERF.md``.)"""
from __future__ import annotations

import pytest
import torch

from perfbench import gen, harness, tiny, weights
from perfbench.checks import leaf_gap, rel_gap
from perfbench.reference import serve as ref_serve
from perfbench.reference import train as ref_train
from perfbench.reference.lowp import round_operand
from perfbench.train import _norms_against_start

CPU = torch.device("cpu")
SEED = 2 ** 31 + 3


def test_tf32_keeps_ten_mantissa_bits_and_fp8_three():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0])
    assert round_operand(x, "tf32").tolist() == [1.0 + 2 ** -10,
                                                 1.0 + 2 ** -10, 1.0, -3.0]
    y = torch.linspace(-448, 448, 1001)
    err = (round_operand(y, "fp8") - y).abs() / y.abs().clamp_min(1)
    assert 2 ** -5 < float(err.max()) <= 2 ** -4


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.manifest()["workloads"]
                                      if w["name"].startswith("train.")])
def test_tf32_control_reads_far_above_the_program(workload):
    c = tiny.cell(workload)
    res = harness.run_cell(c, SEED, 0.2, False, CPU, 0.0)
    prog = {n: v for n, v, _ in res.checks}
    ref_losses, ref_grad, ref_change = res.reference
    W = weights.make(c.config, SEED, torch.float32, CPU)
    method = "onebit" if "onebit" in c.mix["strategy"] else "none"
    losses, grad = ref_train.run(
        W, c.config, gen.train_batches(c.mix, SEED, c.config["vocab_size"],
                                       CPU),
        workers=4, steps=c.mix["check_steps"], lr=c.mix["lr"],
        method=method, lowp="tf32")
    change = _norms_against_start(W, c.config, SEED, torch.float32, CPU,
                                  lambda w, w0: w - w0)
    ctrl = {"loss": rel_gap(losses, ref_losses),
            "grad": leaf_gap(grad, ref_grad, ref_grad),
            "change": leaf_gap(change, ref_change, ref_grad)}
    assert any(ctrl[k] > 3 * prog[k] for k in ctrl), (ctrl, prog)
    assert res.correct and not harness.verdict(ctrl, c.limits), \
        (ctrl, c.limits)


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.manifest()["workloads"]
                                      if w["name"].startswith("serve.")])
def test_fp8_control_reads_far_above_the_program(workload):
    # wide enough, and a sample long enough, that the widest gap of the
    # fp8 control (0.47-0.52 at this size) stands clear of the cell's limit
    c = tiny.cell(workload, d=64, ff=128, V=256)
    c.mix = dict(c.mix, check_tokens=120)
    res = harness.run_cell(c, SEED, 0.3, False, CPU, 0.0)
    W = weights.make(c.config, SEED, getattr(torch, c.config["dtype"]), CPU)
    ctrl, _ = ref_serve.gaps(W, c.config, res.sample, CPU, control="fp8")
    assert ctrl > 3 * res.checks[0][1] and ctrl > 0
    assert res.correct and not harness.verdict({"served_gap": ctrl},
                                               c.limits), (ctrl, c.limits)
