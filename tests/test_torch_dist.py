"""The worker axis over ``torch.distributed``: one process per worker
(``core.collectives.DistAxis``, ``launch.dist.spawn``), Gloo on the CPU,
against the logical axis and the JAX reference.

Three spawns of seconds each (``tests/torch_dist_ranks.py`` holds the
rank functions, which import only torch and the port):

* 8 ranks: every exact schedule over the 8-rank group on
  ``test_torch_train.py``'s ``x`` [8, 1003] against the JAX schedules of
  its ``jax_runs`` (ring, butterfly, tree bit for bit; fully-connected and
  psum within 1e-6); every exact schedule, codec exchange
  (``compressed_allreduce_ef``: ring, butterfly, tree, fully-connected x
  onebit, dgc, terngrad, qsgd), ``make_allreduce`` and ``psum_scatter``
  over the 8 ranks and over sub-groups of 2, 3 and 4 ranks bit for bit
  against the logical axis (butterfly and tree refuse 3 workers on both);
  then ``bsp/allreduce/onebit@8`` and the parameter server's
  ``bsp/ps/dgc:0.05@8`` through ``Trainer.fit`` against the JAX engine
  (losses within 1e-4 per step, wire bytes exact).
  The all-to-all ``psum_scatter`` receives 1/n of what an all-gather
  of the same contributions does.
* 4 ranks: the engine cells of ``R.ENGINE_CELLS`` (BSP allreduce and
  ring in both wire modes; the parameter server's ``bsp/ps`` cells;
  SSP, ASP and SMA on both architectures; backup workers, and measured
  detection with one sleeping worker) through the fit loop against the
  logical engine: event histories (losses, staleness, firing worker,
  drop sets), parameters, wire bytes and each rank's EF row bit for bit;
  ``make_sharded_train_step`` with AdamW and onebit against the logical
  sharded step (metrics, parameters, each rank's EF row).
* 4 ranks again, the elastic interface: ``Trainer(group=).fit(plan=)``
  on the cells of ``R.ELASTIC_CELLS`` (a crash and a regrow, a restart,
  the ssp:2/ring/onebit@4 acceptance plan, resizes 4 -> 2 -> 4 on SMA
  and on measured ``bsp/ps/onebit@4``) against the logical engine:
  histories, recoveries, parameters, wire bytes and EF rows bit for
  bit, and rank 0's snapshots file for file the logical run's
  (manifests with their content hashes); the hybrid engine's elastic
  interface (``HybridEngine(group=)``'s ``reshard``, ``export_state``,
  ``import_state``) on the 4-device cells of ``R.RESTART_SPECS`` and
  ``R.RESHARD_SPECS`` the same way (losses, parameters, wire bytes,
  recoveries, rank 0's manifests); and what a process group still
  refuses (the simulator).
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro_torch.launch.dist import spawn
from test_torch_train import jax_runs, setup  # noqa: F401 (fixture)

torch.set_num_threads(2)

WORLD_A, WORLD_B = 8, 4
JAX_SPECS = ("bsp/allreduce/onebit@8", "bsp/ps/dgc:0.05@8")
TIMEOUT_S = 240
_CACHE = {}


@pytest.fixture(scope="module")
def axis_runs(jax_runs):
    x, _ = jax_runs
    xt = torch.from_numpy(x)
    ranks = spawn(R.axis_rank, WORLD_A, "gloo", device="cpu",
                  args=(xt, setup()["params"], JAX_SPECS),
                  timeout_s=TIMEOUT_S)
    return ranks, R.logical_cases(xt)


@pytest.fixture(scope="module")
def engine_runs():
    params = setup()["params"]
    return spawn(R.engine_rank, WORLD_B, "gloo", device="cpu",
                 args=(params,), timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    params = setup()["params"]
    root = str(tmp_path_factory.mktemp("elastic_ranks"))
    return spawn(R.elastic_rank, WORLD_B, "gloo", device="cpu",
                 args=(params, root), timeout_s=TIMEOUT_S)


def _rows(ranks, k, key):
    """Ranks 0..k-1's values of ``key`` stacked as the logical rows."""
    vals = [ranks[r][k][key] for r in range(k)]
    if isinstance(vals[0], str):
        assert len(set(vals)) == 1
        return vals[0]
    if isinstance(vals[0], dict):
        return {n: torch.cat([v[n] for v in vals]) for n in vals[0]}
    if isinstance(vals[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*vals))
    return torch.cat(vals)


def _equal(a, b):
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


# -------------------------------------------------- schedules against JAX
@pytest.mark.parametrize("name", list(R.SCHEDULES))
def test_schedules_over_8_ranks_match_jax(jax_runs, axis_runs, name):
    _, ref = jax_runs
    ranks, _ = axis_runs
    port = _rows(ranks, WORLD_A, "sched/" + name).numpy()
    if name in ("ring", "butterfly", "tree"):
        np.testing.assert_array_equal(port, ref["sched_" + name])
    else:
        np.testing.assert_allclose(port, ref["sched_" + name], rtol=1e-6,
                                   atol=1e-6)


# --------------------------------------- the dist axis against the logical
def _case_ids():
    ids = []
    for k in (WORLD_A,) + R.SUBGROUPS:
        ids += [(k, "sched/" + n) for n in R.SCHEDULES]
        ids.append((k, "psum_scatter"))
        if k & (k - 1) == 0:
            ids += [(k, f"codec/{t}/{m}") for t in R.CODEC_TOPOLOGIES
                    for m in R.CODEC_METHODS]
            ids += [(k, "allreduce/" + n) for n in R.SCHEDULES]
    return ids


@pytest.mark.parametrize("k,key", _case_ids(),
                         ids=[f"{k}-{key}" for k, key in _case_ids()])
def test_dist_axis_matches_logical(axis_runs, k, key):
    ranks, logical = axis_runs
    got, want = _rows(ranks, k, key), logical[k][key]
    if isinstance(want, str):           # butterfly and tree at 3 workers
        assert "power-of-two" in want
    assert _equal(got, want)


@pytest.mark.parametrize("k", (WORLD_A,) + R.SUBGROUPS)
def test_psum_scatter_receives_one_nth_of_an_all_gather(axis_runs, k):
    ranks, _ = axis_runs
    for r in range(k):
        got, gathered = ranks[r][k]["recv_bytes"]
        assert got > 0 and got * k == gathered


# -------------------------------------------------------- engine cells
@pytest.mark.parametrize("spec", JAX_SPECS)
def test_engine_over_8_ranks_matches_jax_engine(jax_runs, axis_runs, spec):
    _, ref = jax_runs
    ranks, _ = axis_runs
    losses, leaves, wire = ranks[0]["engine"][spec]
    assert len(losses) == R.ENGINE_STEPS
    assert np.abs(np.array(losses) - ref[spec + "/losses"]).max() <= 1e-4
    assert wire == int(ref[spec + "/wire"])
    for i, leaf in enumerate(leaves):
        assert np.abs(leaf.numpy() - ref[f"{spec}/p{i}"]).max() <= 1e-4
    # every rank holds the same replica, losses and bytes
    for r in ranks[1:]:
        got = r["engine"][spec]
        assert got[0] == losses and got[2] == wire
        assert all(torch.equal(a, b) for a, b in zip(got[1], leaves))


def _logical_cell(spec, wire):
    if (spec, wire) not in _CACHE:
        _CACHE[spec, wire] = R.engine_cell(spec, wire, setup()["params"])
    return _CACHE[spec, wire]


@pytest.mark.parametrize("spec,wire", R.ENGINE_CELLS)
def test_engine_over_4_ranks_matches_logical_engine(engine_runs, spec,
                                                    wire):
    hist, leaves, nbytes, ef = _logical_cell(spec, wire)
    sync = spec.split("/")[0].split(":")[0].split("+")[0]
    steps = R.DETECT["steps"] if "+detect" in spec else R.ENGINE_STEPS
    assert len(hist) == steps * (4 if sync in ("ssp", "asp") else 1)
    if sync == "ssp":
        # the bound blocks a fast worker: some push is stale
        assert max(h["max_staleness"] for h in hist) > 0
    if "+detect" in spec:
        # the scheduled drop set, then the measured straggler
        assert [h["dropped"] for h in hist] == [[3], [3],
                                                [R.DETECT["worker"]]]
    for rank, r in enumerate(engine_runs):
        got_hist, got_leaves, got_bytes, got_ef = r["cells"][spec, wire]
        assert got_hist == hist
        assert got_bytes == nbytes
        assert got_leaves == leaves
        # each rank carries its own worker's EF row
        assert got_ef == ef[rank:rank + 1]


def test_sharded_step_over_4_ranks_matches_logical(engine_runs):
    hist, leaves, ef = R.sharded_run(setup()["params"])
    assert len(hist) == R.SHARDED["steps"]
    assert len({h["wire_bytes"] for h in hist}) == 1 and \
        hist[0]["wire_bytes"] > 0
    for rank, r in enumerate(engine_runs):
        got_hist, got_leaves, got_ef = r["sharded"]
        assert got_hist == hist
        assert all(torch.equal(a, b) for a, b in zip(got_leaves, leaves))
        # each rank carries its own worker's EF row, [1, ...]
        assert all(torch.equal(a, b[rank:rank + 1])
                   for a, b in zip(got_ef, ef))


# ---------------------------------------------------- elastic interface
_ELASTIC = {}


def _logical_elastic(cell, root):
    if cell not in _ELASTIC:
        _ELASTIC[cell] = R.elastic_cell(*cell, setup()["params"],
                                        str(root / f"logical{len(_ELASTIC)}"))
    return _ELASTIC[cell]


@pytest.mark.parametrize("cell", R.ELASTIC_CELLS,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in
                              R.ELASTIC_CELLS])
def test_elastic_over_4_ranks_matches_logical(elastic_runs, cell,
                                              tmp_path_factory):
    hist, leaves, nbytes, ef, recs, final, snaps = _logical_elastic(
        cell, tmp_path_factory.mktemp("elastic_logical"))
    spec, _, plan, steps, _ = cell
    # one event a step, or one a worker's push (ssp: 3 workers a step
    # between the crash and the regrow)
    assert len(hist) >= steps and final == 4
    kinds = [r["kind"] for r in recs]
    assert kinds == (["crash"] if "crash" in plan else
                     ["restart"] if "restart" in plan else [])
    # the snapshots carry content hashes, so equal manifests are equal
    # payloads
    assert snaps and all(rec.get("hash") for m in snaps.values()
                         for rec in m["leaves"])
    for rank, r in enumerate(elastic_runs):
        got = r["cells"][cell[:3]]
        assert got[0] == hist
        assert got[1] == leaves
        assert got[2] == nbytes
        # each rank ends with its own worker's EF row
        assert got[3] == ef[rank:rank + 1]
        assert got[4] == recs and got[5] == final
        # rank 0 writes every snapshot, the others none
        assert got[6] == (snaps if rank == 0 else None)


@pytest.mark.parametrize("name", list(R.REFUSALS))
def test_group_refuses_unported_cells(elastic_runs, name):
    want = R.REFUSALS[name][2]
    for r in elastic_runs:
        msg = r["refusals"][name]
        assert msg != "no error" and want in msg, msg


_HYBRID = {}


def _logical_hybrid(cell, root):
    if cell not in _HYBRID:
        _HYBRID[cell] = R.hybrid_elastic_cell(
            *cell, R.restart_inputs(), str(root / f"logical{len(_HYBRID)}"))
    return _HYBRID[cell]


@pytest.mark.parametrize("cell", R.restart_cells(WORLD_B),
                         ids=[f"{c[0]}-{c[1]}" for c in
                              R.restart_cells(WORLD_B)])
def test_hybrid_elastic_over_4_ranks_matches_logical(elastic_runs, cell,
                                                     tmp_path_factory):
    hist, params, nbytes, recs, resizes, final, snaps = _logical_hybrid(
        cell, tmp_path_factory.mktemp("hybrid_logical"))
    spec, plan = cell[:2]
    assert len(hist) == R.RESTART_RUN["steps"] and final == 4
    assert [r["kind"] for r in recs] == [plan.split(":")[0].split("@")[0]]
    assert resizes == plan.count("resize")
    assert snaps and all(rec.get("hash") for m in snaps.values()
                         for rec in m["leaves"])
    for rank, r in enumerate(elastic_runs):
        got = r["hybrid"][cell]
        assert got[0] == hist
        assert all(torch.equal(got[1][k], params[k]) for k in params)
        assert got[2] == nbytes
        assert got[3] == recs and got[4] == resizes and got[5] == final
        # rank 0 writes every snapshot, in the logical layout; the others
        # none
        assert got[6] == (snaps if rank == 0 else None)
