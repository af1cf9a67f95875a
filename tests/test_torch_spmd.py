"""The dry-run's collectives: the port's step partitioned by DTensor over a
fake process group of the production mesh's size (``launch.spmd``,
``launch.cost.CollectiveCounter``), held against an analytic count of
its layout and beside the JAX package's XLA records.

The reference is compiled in one ``run_multidevice`` subprocess with 512
host devices (``torch_spmd_ref.py`` holds its script).  Under the
installed JAX its dry-run fails at the embedding gather on
``jax.make_mesh``'s Explicit axes, so the script replaces
``repro.launch.dryrun.make_production_mesh`` with the same mesh of Auto
axes (nothing under ``src/repro`` changes).

Primitives, redistributions of a ``[1024, 2048]`` tensor on 16 x 16 in
fp32 and bf16: an all-gather, an all-reduce and a shard-dimension move
(an all-to-all) are the same kind in both partitioners, with the same
result bytes and ``traffic_weighted`` in fp32; XLA's CPU backend carries
a bf16 collective in fp32, twice the bytes.  The contraction into a
model-sharded result is a reduce-scatter in DTensor and an all-reduce
with a collective-permute in XLA: pinned as that difference.

TinyLlama-1.1B's four probe pairs on 16 x 16 under the
``attn_hints_seq`` cache policy (both packages' command line default):
each depth's record is, byte for byte, ``megatron_zero3``'s analytic
count of the layout; every kind the reference counts above 1% of its
traffic is non-zero in the port's record, except the differences
``KIND_DIFFERENCES`` names and explains.  RWKV-6's token loop, counted
as one token step times the length, equals the loop run token by token.
"""
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

import torch_spmd_ref
from repro_torch.configs import get_config, get_shape
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun, spmd
from repro_torch.launch.cost import (COLLECTIVE_KINDS, CollectiveCounter,
                                     _traffic)
from repro_torch.launch.mesh import make_production_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = set(COLLECTIVE_KINDS) | {"traffic_weighted"}
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
ARCH = "tinyllama-1.1b"

# (in specs, out spec) of each primitive; the contraction is a [1024,
# 2048] x [2048, 2048] product over the model axis
PRIMITIVES = {
    "all-gather": ([("data", "model")], (None, "model")),
    "all-reduce": ([(None, "model"), ("model", None)], (None, None)),
    "reduce-scatter": ([(None, "model"), ("model", None)], (None, "model")),
    "all-to-all": ([("model", None)], (None, "model")),
}
SHAPES_IN = {1: [(1024, 2048)], 2: [(1024, 2048), (2048, 2048)]}

def megatron_zero3(cfg, shape, layers, n=16, m=16):
    """Per-device result bytes by kind, and ``traffic_weighted``, of one
    step of a dense GQA model (TinyLlama-1.1B) with ``layers`` layers on
    an ``n`` x ``m`` (data x model) mesh, counted from the layout the
    partitioner is meant to give, not from the port's output.

    Megatron's tensor parallelism with ZeRO-3: each weight's data shards
    are gathered before use ([in, out/m] or [in/m, out], bf16); a
    column-parallel product leaves its output sharded over the model
    axis, a row-parallel one all-reduces it (B S d); the gradient of each
    weight comes back as a reduce-scatter (its bytes / (n m)).  The 4 KV
    heads do not divide the model axis: K and V are gathered over it
    before their heads split, and Q's heads at decode.  The vocab is
    sharded over the model axis: the loss reduces its max, its sum and
    the label's logit over the shards ([B/n, S, 1] fp32).  The smaller
    side moves: at decode the activations move, not the weights (the
    column-parallel inputs to the ``d`` shards over the data axis and back
    by reduce-scatter, the row-parallel outputs by all-to-all), and the
    embedding looks up its ``d`` shards of every row.  Decode attention
    over the sequence-sharded cache combines its max, its sum and its
    output over the shards.  Training recomputes each layer group in
    the backward (checkpoint), up to the attention block's output
    (the recompute stops at the last tensor the backward needs).
    DTensor's choices that Megatron's layout does not make, each counted
    here and named: the backward all-reduces the gradient of each of the
    five column-parallel products' input on its own (where one sum of
    three and one of two would do); the gradient of K and V after their
    head repeat is gathered over the model axis; and Adam's moments of
    the stacked layers are replicated, as the reference's spec lookup
    leaves every leaf under a list (``launch.specs.opt_state_specs``), so
    each of its two moment updates gathers the fp32 gradient over the
    data axis and then the model axis, and all-reduces each norm's."""
    BF, F4, I4 = 2, 4, 4
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    P = 2 * d * q + 2 * d * kv + 3 * d * ff     # a layer's weights
    B, S = shape.global_batch, shape.seq_len
    ops = []                                    # (kind, result bytes)

    def add(kind, nbytes, count=1):
        ops.extend([(kind, nbytes)] * count)

    if shape.kind == "train":
        T = B // n * S                          # tokens per data shard
        add("all-gather", V // m * d * BF, 2)   # embedding, lm_head
        add("all-reduce", T * F4, 3)            # the loss over the vocab
        add("all-reduce", T * d * BF, 2)        # embedding; lm_head's grad
        add("all-reduce", d * F4, 2)            # Adam: final norm's grad
        add("all-reduce", F4)                   # the loss
        add("reduce-scatter", V * d // (n * m) * BF, 2)
        for _ in range(layers):
            add("all-gather", P // m * BF, 2)   # forward, recompute
            add("all-gather", T * kv * BF, 4)   # K, V heads x 2
            add("all-gather", T * q * BF, 2)    # K, V grads after repeat
            add("all-gather", (P // n + P) * F4, 2)     # Adam's m, v
            add("all-reduce", T * d * BF, 2 + 1 + 5)
            add("all-reduce", d * F4, 4)        # Adam: 2 norms' grads x 2
            add("reduce-scatter", P // (n * m) * BF)
    elif shape.kind == "prefill":
        T = B // n * S
        add("all-gather", V // m * d * BF)      # embedding
        add("all-reduce", T * d * BF)           # its vocab shards
        add("all-to-all", B * d // n * BF)      # last token into lm_head
        add("reduce-scatter", B // n * V // m * BF)
        for _ in range(layers):
            add("all-gather", P // m * BF)
            add("all-gather", T * kv * BF, 2)
            add("all-reduce", T * d * BF, 2)
    elif B >= n:                                # decode, batch over data
        b = B // n
        add("all-gather", B * I4)               # the token ids
        add("all-reduce", B * d // n * BF)      # embedding's vocab shards
        add("all-to-all", b * d * BF)           # its rows onto the batch
        add("all-to-all", B * d // n * BF)      # into lm_head
        add("reduce-scatter", b * V // m * BF)  # lm_head's output
        for _ in range(layers):
            add("all-gather", b * q * BF)       # Q's heads
            add("all-gather", b * kv * BF, 2)   # K, V heads
            add("all-gather", B * q // m * BF)  # w_o's input
            add("all-gather", B * ff // m * BF)     # w_down's input
            add("all-reduce", b * q * BF)       # attention over the shards
            add("all-reduce", b * cfg.num_heads * F4, 2)    # max, sum
            add("all-reduce", B * d // n * BF, 2)   # row-parallel outputs
            add("all-to-all", b * d * BF, 2)        # ... onto the batch
            add("all-to-all", B * d // n * BF, 5)   # column-parallel inputs
            add("reduce-scatter", b * q // m * BF)
            add("reduce-scatter", b * kv // m * BF, 2)
            add("reduce-scatter", b * ff // m * BF, 2)
    else:                                       # decode of B < n rows
        add("all-gather", B * d * BF)           # embedding's d shards
        add("all-reduce", B * d // n * BF)      # its vocab shards
        add("all-reduce", B * V // m * BF)      # lm_head's output
        for _ in range(layers):
            add("all-gather", B * q * BF)
            add("all-gather", B * kv * BF, 2)
            add("all-gather", B * d * BF, 2)    # row-parallel outputs
            add("all-reduce", B * q * BF)
            add("all-reduce", B * cfg.num_heads * F4, 2)
            add("all-reduce", B * q // m * BF)  # column-parallel outputs
            add("all-reduce", B * kv // m * BF, 2)
            add("all-reduce", B * ff // m * BF, 2)
            add("all-reduce", B * d // n * BF, 2)   # row-parallel outputs
    rec = {k: float(sum(b for kk, b in ops if kk == k))
           for k in COLLECTIVE_KINDS}
    # every collective runs over one mesh axis of 16
    rec["traffic_weighted"] = sum(_traffic(k, b, 16) for k, b in ops)
    return rec


# kinds the reference counts above 1% of its traffic that the port's
# record leaves at or near 0, and why
KIND_DIFFERENCES = {
    ("train_4k", "all-to-all"):
        "XLA moves activations between batch and head shards around "
        "attention by all-to-all; the port keeps the batch on the data "
        "axis and gathers K and V over the model axis (4 KV heads do not "
        "divide it), and their repeated heads' gradient, by all-gathers",
}


@pytest.fixture(scope="module")
def ref(multidevice):
    script = torch_spmd_ref.ref_script(ARCH, SHAPES, prims=PRIMITIVES)
    return torch_spmd_ref.parse(multidevice(script, 512, timeout=600))


def _port_primitive(name, dtype):
    ins, spec = PRIMITIVES[name]
    args = tuple(torch.empty(s, dtype=getattr(torch, dtype), device="meta")
                 for s in SHAPES_IN[len(ins)])
    # ``torch.mm``: DTensor's own partition (``x @ w`` takes the
    # partitioner's Megatron rule)
    fn = torch.mm if len(ins) == 2 else (lambda a: a * 1)
    return spmd.run_counted(fn, args, tuple(ins), lambda out: spec,
                            make_production_mesh())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_beside_xla(ref, name, dtype):
    got, want = _port_primitive(name, dtype), ref["prims"][f"{name}:{dtype}"]
    assert set(got) == KEYS
    assert {k for k in COLLECTIVE_KINDS if got[k]} == {name}
    # XLA's CPU backend carries bf16 collectives in fp32
    wide = 2 if dtype == "bfloat16" else 1
    if name == "reduce-scatter":
        # XLA sums the [1024, 128] shards with an all-reduce and moves
        # them with a collective-permute; DTensor reduce-scatters
        assert {k for k in COLLECTIVE_KINDS if want[k]} == {
            "all-reduce", "collective-permute"}
        assert want["all-reduce"] == want["collective-permute"] == \
            wide * got["reduce-scatter"] == 1024 * 128 * 4
        return
    assert {k for k in COLLECTIVE_KINDS if want[k]} == {name}
    assert want[name] == wide * got[name]
    assert want["traffic_weighted"] == wide * got["traffic_weighted"]


@pytest.fixture(scope="module")
def port_probes(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    return {s: dryrun.probe_pair(ARCH, s, False, str(out), force=True,
                                 cache_policy="attn_hints_seq")
            for s in SHAPES}


@pytest.mark.parametrize("shape_name", SHAPES)
def test_tinyllama_probe_is_megatron_zero3(port_probes, shape_name):
    """Each depth's count is the analytic count of its layout, kind by
    kind and byte for byte."""
    rec = port_probes[shape_name]
    assert rec["status"] == "ok"
    for groups in (1, 2):
        cfg = dryrun._depth_variant(get_config(ARCH), groups)
        want = megatron_zero3(cfg, get_shape(shape_name), groups)
        assert rec[f"collectives_n{groups}"] == want, groups


@pytest.mark.parametrize("shape_name", SHAPES)
def test_tinyllama_probe_beside_reference(ref, port_probes, shape_name):
    rec = port_probes[shape_name]
    for key in ("collectives", "collectives_n1", "collectives_n2"):
        assert set(rec[key]) == KEYS, key
    want = ref["probes"][shape_name]["collectives"]
    got = rec["collectives"]
    for kind in COLLECTIVE_KINDS:
        share = _traffic(kind, want[kind], 16) / want["traffic_weighted"]
        if share > 0.01 and not got[kind]:
            assert (shape_name, kind) in KIND_DIFFERENCES, (kind, share)
    mib = {k: (round(got[k] / 2**20, 2), round(want[k] / 2**20, 2))
           for k in sorted(KEYS)}
    print(f"{shape_name} (port, reference) MiB: {mib}")


@pytest.mark.parametrize("shape_name", SHAPES)
def test_probe_extrapolates_its_depths(port_probes, shape_name):
    rec = port_probes[shape_name]
    assert rec["collectives"] == dryrun._extrap(
        rec["collectives_n1"], rec["collectives_n2"], rec["extrap_mult"])
    assert not dist.is_initialized()


def test_count_leaves_no_process_group():
    cfg = dryrun._depth_variant(get_config(ARCH), 1)
    rec = spmd.count_pair(cfg, get_shape("decode_32k"), True)
    assert set(rec) == KEYS and rec["traffic_weighted"] > 0
    assert not dist.is_initialized()


def test_count_refuses_an_existing_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="default process group"):
            spmd.count_pair(dryrun._depth_variant(get_config(ARCH), 1),
                            get_shape("decode_32k"), False)
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


def test_a_failed_count_is_recorded_with_its_op():
    def step(x):            # a row write into a sharded tensor, in place
        rows = torch.arange(4, device=x.device)
        x[rows, rows] = torch.zeros(4, device=x.device)
        return x
    with pytest.raises(RuntimeError) as err:
        spmd.run_counted(step, (torch.empty(64, 64, device="meta"),),
                         (("data", "model"),), lambda out: None,
                         make_production_mesh())
    assert spmd.failure(err.value).startswith(
        "aten.index_put_.default: in-place")
    assert not dist.is_initialized()


@pytest.mark.parametrize("kind,group", [("all-reduce", 16),
                                        ("all-gather", 256),
                                        ("reduce-scatter", 16)])
def test_counter_reads_each_ops_group(kind, group):
    """Result bytes by the reference's convention (the gathered tensor,
    the reduce-scatter's shard) and traffic with the op's own group."""
    from torch.distributed._functional_collectives import (
        all_gather_tensor, all_reduce, reduce_scatter_tensor)
    with spmd.fake_group(256):
        dm = spmd.device_mesh(make_production_mesh(), [("data", "model")])
        x = torch.empty(64, 32, device="meta")
        ops = {"all-reduce": lambda: all_reduce(x, "sum", (dm, 0)),
               "all-gather": lambda: all_gather_tensor(
                   x, 0, dm["data_model"]),
               "reduce-scatter": lambda: reduce_scatter_tensor(
                   x, "sum", 0, (dm, 1))}
        counter = CollectiveCounter()
        with counter:
            out = ops[kind]()
        r = out.numel() * 4
        assert r == {"all-reduce": 8192, "all-gather": 256 * 8192,
                     "reduce-scatter": 8192 // 16}[kind]
        assert counter.record() == dict(
            {k: float(r) if k == kind else 0.0 for k in COLLECTIVE_KINDS},
            traffic_weighted=_traffic(kind, r, group))
    assert not dist.is_initialized()


def test_importing_the_port_leaves_fake_pg_out():
    code = ("import sys, repro_torch, repro_torch.launch.dryrun, "
            "repro_torch.launch.spmd, repro_torch.launch.cost; "
            "assert 'torch.testing._internal.distributed.fake_pg' "
            "not in sys.modules")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_rwkv_token_loop_counts_every_token(kind):
    """RWKV-6's loop counted as its first, middle and last token steps,
    the middle one's collectives times the S - 2 middle tokens, has the
    collectives of the loop run token by token, forward and backward
    (the checkpoint's recompute included)."""
    cfg = dryrun._depth_variant(get_config("rwkv6-7b"), 1)
    shape = InputShape(f"{kind}_5", 5, 16, kind)
    assert spmd.count_pair(cfg, shape, False) == spmd.count_pair(
        cfg, shape, False, unroll=True)


@pytest.mark.parametrize("seq", [4, 5])
def test_token_loop_weighs_a_moving_state(seq):
    """The loop alone with its inputs sharded on the head size over the
    model axis, so that every token step moves its state and inputs:
    counted and unrolled agree, and each token adds its moves."""
    from repro_torch.models import rwkv6

    def step(*xs):
        xs = [x.detach().requires_grad_() for x in xs]
        y, state = rwkv6._wkv(*xs)
        return torch.autograd.grad(y.sum() + state.sum(), xs)

    def count(seq, unroll):
        B, H, hs = 32, 64, 64
        args = [torch.empty(B, seq, H, hs, device="meta")] * 4 + [
            torch.empty(1, H, hs, 1, device="meta"),
            torch.empty(B, H, hs, hs, device="meta")]
        specs = (("data", None, None, "model"),) * 4 + (
            (None,) * 4, ("data", "model", None, None))
        return spmd.run_counted(step, args, specs, lambda out: None,
                                make_production_mesh(), unroll=unroll)

    once = count(seq, False)
    assert once == count(seq, True)
    fewer = count(seq - 1, False)["traffic_weighted"]
    assert once["traffic_weighted"] > fewer > 0


def _real_cache_write(cache, new):
    cache[torch.arange(4), torch.zeros(4, dtype=torch.long)] = new


@pytest.mark.parametrize("op", [
    lambda x: _real_cache_write(x, x[:, 0]),
    lambda x: torch.einsum("bld,bld->bl", x, x),
    lambda x: x + 1])
def test_partitioner_refuses_real_shards(op):
    """The rules hold on meta shards only (a cache write writes rank 0's
    rows, RWKV's loop stands one token for all): a DTensor with storage
    raises under them, whatever the op."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    with spmd.fake_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        x = DTensor.from_local(torch.zeros(1, 8, 2), mesh, [Shard(1)],
                               run_check=False)
        with spmd.installed(), pytest.raises(NotImplementedError,
                                             match="meta shards only"):
            op(x)
    assert not dist.is_initialized()


def test_installed_puts_the_models_back():
    from repro_torch.models import rwkv6, transformer, whisper
    before = rwkv6._wkv, transformer.checkpoint, whisper.checkpoint
    with spmd.installed():
        assert rwkv6._wkv is not before[0]
        assert transformer.checkpoint is not before[1]
    assert (rwkv6._wkv, transformer.checkpoint, whisper.checkpoint) == before
