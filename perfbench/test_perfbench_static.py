"""The benchmark's files resolve by name, import nothing they must not,
and count operations, tails and traffic as written."""
from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import gen, harness, readers
from perfbench.reference.transformer import dims
from perfbench.serve import Record, pool_tokens, ttft_p90_ms, waits
from perfbench.stats import percentile

HERE = Path(__file__).resolve().parent
MAN = harness.manifest()
WORKLOADS = [w["name"] for w in MAN["workloads"]]
CONFIGS = {c["name"]: harness.load_json(harness.ROOT / c["file"])
           for c in MAN["configs"]}


# ------------------------------------------------------------ by name
@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves_by_name(workload):
    c = harness.resolve(MAN, workload)
    assert c.mix["kind"] in harness.DRIVERS
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert set(c.limits) >= {"served_gap"} or \
        set(c.limits) >= {"loss", "grad", "change"}


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_every_metric_names_known_cells_and_layers(metric):
    m = {x["name"]: x for x in MAN["per_layer"]}[metric]
    assert set(m["workloads"]) <= set(WORKLOADS)
    e2e = {x["name"]: x for x in MAN["end_to_end"]}
    assert m["moves"] in e2e
    moved = e2e[m["moves"]].get("workloads", WORKLOADS)
    assert set(m["workloads"]) <= set(moved)
    assert m["layer"] in (HERE.parent / "PERF.md").read_text()


@pytest.mark.parametrize("kernel", ["flash_attention", "flash_decode",
                                    "onebit_encode_ef"])
def test_kernel_counts_load(kernel):
    assert callable(harness.load_module("kernels", kernel).nbytes)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_file_is_what_the_program_runs(name):
    """The program's config over the file's ``port`` section has the
    file's widths, and every key the file says it changed exists."""
    from perfbench import port
    cfg = CONFIGS[name]
    m, p = dims(cfg), port.model_config(cfg)
    assert (p.num_layers, p.d_model, p.num_heads, p.num_kv_heads,
            p.head_dim, p.d_ff, p.vocab_size) == \
        (m["L"], m["d"], m["H"], m["KV"], m["hd"], m["ff"], m["V"])
    assert p.norm == m["norm"] and p.norm_eps == m["eps"]
    assert p.rope_theta == m["theta"] and m["rot"] == m["hd"]
    assert tuple(p.mrope_sections) == m["sections"]
    assert p.tie_embeddings == m["tied"]
    for key in cfg["reduced"]:
        assert key in cfg and key in cfg["departures"]
    entry = {c["name"]: c for c in MAN["configs"]}[name]
    assert entry["reduced"] == cfg["reduced"]


def test_manifest_shape():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["perfbench"]
    for w in MAN["workloads"]:
        assert (HERE / "limits" / f"{w['name']}.json").exists()
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    assert json.loads((HERE / "peaks.json").read_text())


# ------------------------------------------------------- isolation
def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(HERE).as_posix()
                                        for p in HERE.rglob("*.py")))
def test_imports_no_jax_and_reference_no_program(path):
    names = set(_imports(HERE / path))
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names
    if path.startswith("reference/"):
        assert "repro_torch" not in names, names


def test_refused_modules_compare_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torchlike", types.ModuleType("x"))
    assert not [m for m in harness.forbidden_modules() if m.startswith("repro_")]
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro.core" in harness.forbidden_modules()


# ------------------------------------------------------- arithmetic
def test_matmul_parameters_equal_the_hand_counts():
    assert sum(readers.matmul_params(CONFIGS["stablelm-2-1.6b"])) == \
        24 * (4 * 2048 ** 2 + 3 * 2048 * 5632) + 2048 * 100352 == 1438646272
    assert sum(readers.matmul_params(CONFIGS["qwen2-vl-7b"])) == \
        28 * (2 * 3584 ** 2 + 2 * 3584 * 512 + 3 * 3584 * 18944) \
        + 3584 * 152064 == 7070285824


def test_model_flops_follow_the_formulas():
    s, q = CONFIGS["stablelm-2-1.6b"], CONFIGS["qwen2-vl-7b"]
    assert readers.train_flops_per_token(s, 2048) == \
        6 * 1438646272 + 12 * 24 * 2048 * 2048
    layers, head = readers.matmul_params(q)
    assert readers.decode_flops(q, 100) == \
        2 * 7070285824 + 4 * 28 * 28 * 128 * 100
    assert readers.prefill_flops(q, 3) == \
        2 * layers * 3 + 2 * head + 4 * 28 * 28 * 128 * 6


def test_kernel_counts_by_hand():
    fa = harness.load_module("kernels", "flash_attention")
    # 2 heads of 4 dims over 3 positions: 6 attended pairs x 2 x 4 x 2 x 2
    assert fa.flops(1, 3, 2, 4) == 6 * 4 * 4 * 2
    assert fa.nbytes(1, 3, 2, 1, 4, 2) == (2 * 3 * 2 * 4 + 2 * 3 * 4) * 2
    fd = harness.load_module("kernels", "flash_decode")
    assert fd.nbytes([5, 7], 3, 4, 2, 8, 2) == (12 * 2 * 2 * 8 + 2 * 3 * 4 * 8) * 2
    ob = harness.load_module("kernels", "onebit_encode_ef")
    assert ob.nbytes(2, 256, mask=True) == 2 * 256 * 14 + 16


def test_percentile_is_numpy_linear():
    xs = list(np.random.default_rng(0).random(37))
    for q in (50, 90, 95):
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_tails_are_taken_over_every_request_due():
    offers = [gen.Offer(float(i), np.zeros(2, np.int64), 4) for i in range(10)]
    recs = [Record(o, None) for o in offers]
    for r in recs[:5]:
        r.first = r.offer.due + 0.1
    # five never got a token: they count what they waited by the window's end
    w = waits(recs, "first", 20.0)
    assert sorted(w)[:5] == pytest.approx([0.1] * 5)
    assert sorted(w)[5:] == pytest.approx([15.0, 14.0, 13.0, 12.0, 11.0][::-1])
    assert ttft_p90_ms(recs, 20.0) == pytest.approx(1e3 * percentile(w, 90))


# ----------------------------------------------------------- traffic
SERVE_MIXES = sorted({w["traffic"] for w in MAN["workloads"]
                      if harness.load_json(HERE / "traffic" /
                                           f"{w['traffic']}.json")["kind"]
                      == "serve"})


@pytest.mark.parametrize("mix_name", SERVE_MIXES)
def test_serving_traffic_is_a_function_of_the_seed(mix_name):
    mix = harness.load_json(HERE / "traffic" / f"{mix_name}.json")
    big = 2 ** 31 + 977
    a, b = gen.offers(mix, big, 30.0, 1000), gen.offers(mix, big, 30.0, 1000)
    assert [o.due for o in a] == [o.due for o in b]
    assert all((x.prompt == y.prompt).all() for x, y in zip(a, b))
    c = gen.offers(mix, big + 1, 30.0, 1000)
    assert [len(o.prompt) for o in a] != [len(o.prompt) for o in c]
    assert [o.due for o in a] != [o.due for o in c]
    for o in a:
        assert mix["prompt"]["min"] <= len(o.prompt) <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= o.max_new <= mix["output"]["max"]
        assert o.due > 0
    # the process outlasts the window: requests are still due at its close
    assert a[-1].due > 30.0


@pytest.mark.parametrize("mix_name", SERVE_MIXES)
def test_every_seed_offers_the_same_sizes_at_poisson_times(mix_name):
    mix = harness.load_json(HERE / "traffic" / f"{mix_name}.json")
    rate = mix["arrivals"]["rate_per_s"]
    a, b = gen.offers(mix, 1, 50.0, 10), gen.offers(mix, 2, 50.0, 10)
    assert len(a) == len(b)
    assert sorted(len(o.prompt) for o in a) == sorted(len(o.prompt) for o in b)
    assert sorted(o.max_new for o in a) == sorted(o.max_new for o in b)
    assert [len(o.prompt) for o in a] != [len(o.prompt) for o in b]
    assert abs(np.median([len(o.prompt) for o in a]) - mix["prompt"]["median"]) \
        < 0.05 * mix["prompt"]["median"]
    # exponential gaps at the mix's rate, over many seeds' windows
    gaps = np.concatenate([np.diff([0.0] + [o.due for o in
                                            gen.offers(mix, s, 50.0, 10)])
                           for s in range(20)])
    assert abs(gaps.mean() * rate - 1) < 0.05
    assert abs(np.median(gaps) / gaps.mean() - np.log(2)) < 0.05
    due = [sum(o.due < 50.0 for o in gen.offers(mix, s, 50.0, 10))
           for s in range(20)]
    assert abs(np.mean(due) / (50.0 * rate) - 1) < 0.05
    assert np.std(due) > 0.5 * (50.0 * rate) ** 0.5
    # the sizes' order is balanced: the requests a window serves, a prefix
    # of the offers, carry the same work whatever the seed
    for k in (len(a) // 4, len(a) // 2):
        means = [np.mean([len(o.prompt) for o in gen.offers(mix, s, 50.0, 10)[:k]])
                 for s in range(20)]
        whole = np.mean([len(o.prompt) for o in a])
        assert max(abs(m / whole - 1) for m in means) < 0.06


@pytest.mark.parametrize("mix_name", SERVE_MIXES)
def test_the_page_pool_holds_the_longest_request(mix_name):
    mix = harness.load_json(HERE / "traffic" / f"{mix_name}.json")
    assert pool_tokens(mix) % mix["page_size"] == 0
    assert gen.max_len(mix) <= pool_tokens(mix) <= \
        mix["slots"] * gen.max_len(mix)


def test_kv_live_share_weighs_iterations_by_their_wall():
    from types import SimpleNamespace
    mix = {"page_size": 4, "slots": 2, "pool_tokens": 100,
           "prompt": {"max": 40}, "output": {"max": 10}}
    run = SimpleNamespace(mix=mix, untraced=10.0, iterations=[
        (0.0, 1.0, [20], [], True), (1.0, 4.0, [], [21, 30], False),
        (9.0, 11.0, [], [60], False)])
    share = harness.load_module("metrics", "kv_live_pct.serve").read(run)
    assert share == pytest.approx(100.0 * (20 + 3 * 51) / (4 * 100))


def test_training_stream_is_a_function_of_seed_step_and_worker():
    big = 2 ** 31 + 5
    a = gen.markov_rows(big, 3, 1, 2, 64, 1000, 0.1)
    assert (a == gen.markov_rows(big, 3, 1, 2, 64, 1000, 0.1)).all()
    assert (a != gen.markov_rows(big, 3, 2, 2, 64, 1000, 0.1)).any()
    assert (a != gen.markov_rows(big, 4, 1, 2, 64, 1000, 0.1)).any()
    assert (a[0] != a[1]).any() and a.min() >= 0 and a.max() < 1000
    follows = (a[:, 1:] == (3 * a[:, :-1] + 7) % 1000).mean()
    assert 0.8 < follows < 0.97
