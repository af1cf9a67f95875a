"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a cell, cut to a CPU size (the harness's
look for a card is skipped), with one fault planted in the program: a
step that returns its state unchanged, half of the batch left out and the
mean taken over the rest, the exchange between the workers left out, a
token altered where it is produced.  The cell's own limits judge it."""
from __future__ import annotations

import pytest
import torch

from perfbench import harness, tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 913
TRAIN = [w["name"] for w in harness.manifest()["workloads"]
         if w["name"].startswith("train.")]
SERVE = [w["name"] for w in harness.manifest()["workloads"]
         if w["name"].startswith("serve.")]


def _run(workload):
    return harness.run_cell(tiny.cell(workload), SEED, 0.3, False, CPU, 0.0)


def _plant_exchange(monkeypatch, rewrite):
    """Route both exchanges of ``CommPlan`` through ``rewrite(grads)``."""
    from repro_torch.comm import plan as P
    exchange, reduce = P.CommPlan.exchange, P.CommPlan.reduce_grads
    monkeypatch.setattr(P.CommPlan, "exchange", lambda self, g, ef, gen=None,
                        axis=None: rewrite(self, g, ef, exchange, True))
    monkeypatch.setattr(P.CommPlan, "reduce_grads", lambda self, g, axis=None:
                        rewrite(self, g, None, reduce, False))


@pytest.mark.parametrize("workload", TRAIN)
def test_train_unchanged_state_is_caught(workload, monkeypatch):
    from repro_torch.core import tree
    monkeypatch.setattr(tree.LeafLayout, "update",
                        lambda self, t, leaves, fn: t)
    res = _run(workload)
    assert not res.correct and dict((n, v) for n, v, _ in res.checks)[
        "change"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", TRAIN)
def test_train_half_batch_is_caught(workload, monkeypatch):
    def rewrite(self, grads, ef, real, codec):
        half = [list(g) for g in grads[:len(grads) // 2]]
        grads = half + [list(g) for g in half]
        return real(self, grads, ef) if codec else real(self, grads)
    _plant_exchange(monkeypatch, rewrite)
    assert not _run(workload).correct


@pytest.mark.parametrize("workload", TRAIN)
def test_train_exchange_left_out_is_caught(workload, monkeypatch):
    def rewrite(self, grads, ef, real, codec):
        own = [g.float() for g in grads[0]]
        if not codec:
            return own
        return own, ef, torch.zeros(len(grads), dtype=torch.int64)
    _plant_exchange(monkeypatch, rewrite)
    assert not _run(workload).correct


@pytest.mark.parametrize("workload", SERVE)
def test_serve_altered_token_is_caught(workload, monkeypatch):
    from repro_torch.serve import engine as E
    real = E.sample_tokens

    def altered(logits, vocab, *a):
        return (real(logits, vocab, *a) + 1) % vocab
    monkeypatch.setattr(E, "sample_tokens", altered)
    res = _run(workload)
    assert not res.correct and res.checks[0][1] > 0


@pytest.mark.parametrize("workload", SERVE)
def test_serve_unchanged_cache_is_caught(workload, monkeypatch):
    from repro_torch.serve import cache
    monkeypatch.setattr(cache.PagedKV, "scatter",
                        lambda self, store, new, bt, pos, active: store)
    assert not _run(workload).correct


@pytest.mark.parametrize("workload", SERVE)
def test_serve_half_batch_is_caught(workload, monkeypatch):
    from repro_torch.models import transformer as T
    real = T.decode_step

    def half(params, cfg, caches, token, pos, *a, **kw):
        logits, caches = real(params, cfg, caches, token, pos, *a, **kw)
        logits[1::2] = 0
        return logits, caches
    monkeypatch.setattr(T, "decode_step", half)
    assert not _run(workload).correct
