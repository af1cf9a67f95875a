"""The port's checkpoint store, registry and ``generate`` against the JAX
package's, on the CPU.

* The cases of ``tests/test_checkpoint.py`` (roundtrip, sharding, the
  atomic crash with ``np.savez`` raising, replace, the ``extra`` blob, the
  registry) and ``tests/test_preemption.py``'s incremental-save case, on
  the port's trees of tensors.
* Exact, across packages: the same numpy tree of fp32, int32 and bf16
  leaves saved by each gives equal manifests (per-leaf hashes included);
  a checkpoint written by either package loads in the other with equal
  arrays; a bf16 leaf written by ``repro`` loads here with the same bits;
  reduced RecurrentGemma (bf16 beside fp32 leaves) and Whisper carry over
  both ways bit for bit.
* Greedy tokens, bitwise: ``generate`` on reduced TinyLlama with the JAX
  init's weights equals ``repro.serve.generate``; the quickstart (5 Adam +
  onebit steps, save, register, reload, 12 tokens from ``[[1, 2, 3,
  4]]``) equals ``repro``'s; a JAX-written model checkpoint loaded by the
  port's store into the JAX structure and carried over with
  ``from_jax_params`` decodes the same tokens.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ModelRegistry as JaxModelRegistry
from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.core.precision import PrecisionPolicy as JaxPrecisionPolicy
from repro.data import LMDataConfig as JaxLMDataConfig
from repro.data import make_lm_batches as jax_make_lm_batches
from repro.models import build_model as jax_build_model
from repro.optim import Adam as JaxAdam
from repro.serve import generate as jax_generate
from repro.train import Strategy as JaxStrategy
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro.train import train_loop as jax_train_loop
from repro_torch.checkpoint import (ModelRegistry, is_valid_checkpoint,
                                    load_checkpoint, read_manifest,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.tree import get_path, leaf_paths, tree_map
from repro_torch.data import LMDataConfig, make_lm_batches
from repro_torch.models import build_model
from repro_torch.models.transformer import from_jax_params
from repro_torch.optim import Adam
from repro_torch.serve import generate, greedy_sample
from repro_torch.serve.sampling import greedy_sample as sampling_greedy
from repro_torch.train import (Strategy, TrainState, make_train_step,
                               train_loop)

torch.set_num_threads(2)

_CACHE = {}


def setup():
    if not _CACHE:
        jcfg = jax_get_config("tinyllama-1.1b").reduced()
        cfg = get_config("tinyllama-1.1b").reduced()
        jmodel, model = jax_build_model(jcfg), build_model(cfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        _CACHE.update(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model,
                      jparams=jparams,
                      params=from_jax_params(cfg,
                                             jax.tree.map(np.array, jparams)))
    return _CACHE


def _leaves(tree):
    return [get_path(tree, p) for p in leaf_paths(tree)
            if get_path(tree, p) is not None]


def _tree(seed):
    rng = np.random.RandomState(seed)
    t = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return {"embed": t(64, 16),
            "layers": [{"w": t(16, 16), "b": torch.zeros(16)},
                       {"w": t(16, 16), "b": torch.ones(16)}],
            "step_scale": torch.tensor(0.5)}


# ------------------------------------- tests/test_checkpoint.py, ported
def test_save_load_roundtrip(tmp_path):
    tree = _tree(0)
    manifest = save_checkpoint(str(tmp_path / "ckpt"), tree, step=42)
    assert manifest["shards"] >= 1
    restored, step = load_checkpoint(str(tmp_path / "ckpt"), tree)
    assert step == 42
    assert isinstance(restored["layers"], list)
    for a, b in zip(_leaves(restored), _leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_sharding_by_size(tmp_path):
    tree = {"big": torch.ones(1000, 100), "small": torch.ones(10)}
    manifest = save_checkpoint(str(tmp_path / "c"), tree, shard_bytes=100_000)
    assert manifest["shards"] >= 2       # 400KB leaf forces multiple shards
    restored, _ = load_checkpoint(str(tmp_path / "c"), tree)
    assert float(restored["big"].sum()) == 100_000


def test_atomic_save_crash_leaves_old_checkpoint_intact(tmp_path,
                                                        monkeypatch):
    """A crash mid-save (np.savez raising) must not tear the previous
    checkpoint: writes stage in a temp dir and commit via os.replace."""
    path = str(tmp_path / "ckpt")
    old = {"w": torch.arange(8.0)}
    save_checkpoint(path, old, step=7)

    def exploding_savez(file, **arrs):
        raise IOError("disk died mid-save")

    monkeypatch.setattr(np, "savez", exploding_savez)
    with pytest.raises(IOError):
        save_checkpoint(path, {"w": torch.zeros(8)}, step=8)
    monkeypatch.undo()

    # no stray staging dirs, and the old checkpoint still loads
    assert os.listdir(str(tmp_path)) == ["ckpt"]
    assert is_valid_checkpoint(path)
    restored, step = load_checkpoint(path, old)
    assert step == 7
    assert torch.equal(restored["w"], torch.arange(8.0))


def test_atomic_save_replaces_existing_checkpoint(tmp_path):
    path = str(tmp_path / "c")
    save_checkpoint(path, {"w": torch.zeros(4)}, step=1)
    save_checkpoint(path, {"w": torch.ones(4)}, step=2)
    restored, step = load_checkpoint(path, {"w": torch.zeros(4)})
    assert step == 2
    assert float(restored["w"].sum()) == 4.0
    assert sorted(os.listdir(str(tmp_path))) == ["c"]   # no .old aside left


def test_manifest_extra_roundtrip(tmp_path):
    path = str(tmp_path / "c")
    extra = {"num_workers": 3, "tick": 17, "batch_idx": [4, 2, 0]}
    save_checkpoint(path, {"w": torch.zeros(4)}, step=5, extra=extra)
    man = read_manifest(path)
    assert man["step"] == 5
    assert man["extra"] == extra
    assert not is_valid_checkpoint(str(tmp_path / "nope"))


def test_registry_query_and_lineage(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    a = reg.register("lm", "/ck/a", arch="tinyllama-1.1b",
                     metrics={"loss": 3.2}, hyperparams={"lr": 1e-3})
    b = reg.register("lm", "/ck/b", arch="tinyllama-1.1b",
                     metrics={"loss": 2.8}, parent=a)
    c = reg.register("other", "/ck/c", arch="rwkv6-7b",
                     metrics={"loss": 9.0})
    assert reg.get(b)["version"] == 1
    assert len(reg.query(name="lm")) == 2
    assert reg.query(arch="rwkv6-7b")[0]["id"] == c
    assert reg.lineage(b) == [b, a]
    assert reg.best("lm", "loss", maximize=False)["id"] == b


def test_registry_persistence_and_index_shared_with_jax(tmp_path):
    root = str(tmp_path / "reg2")
    reg = ModelRegistry(root)
    reg.register("m", "/x", metrics={"acc": 0.9}, timestamp=1.0)
    reg2 = ModelRegistry(root)       # reload from disk
    assert len(reg2.query(name="m")) == 1
    # the same JSON index: each package reads the other's entries
    jreg = JaxModelRegistry(root)
    jid = jreg.register("m", "/y", parent="m:v0", timestamp=2.0)
    assert ModelRegistry(root).lineage(jid) == ["m:v1", "m:v0"]
    assert JaxModelRegistry(root).get("m:v0") == ModelRegistry(root).get(
        "m:v0")


# ----------------------------- tests/test_preemption.py:273, ported
def test_incremental_save_links_unchanged_shards_and_restores_bitwise(
        tmp_path):
    """Periodic saves hash-skip unchanged shards (hard-linked from the
    previous snapshot); restore is bitwise either way."""
    tree = {"a": torch.arange(64, dtype=torch.float32),
            "b": torch.ones(32),
            "c": torch.full((16,), 7, dtype=torch.int32)}
    base = str(tmp_path / "step_000001")
    save_checkpoint(base, tree, step=1, shard_bytes=200, hash_leaves=True)
    # change exactly one leaf; the others' shards must be linked
    tree2 = dict(tree, a=tree["a"] + 1)
    nxt = str(tmp_path / "step_000002")
    m2 = save_checkpoint(nxt, tree2, step=2, shard_bytes=200,
                         incremental_from=base)
    assert m2["shards"] > 1
    assert 1 <= m2["linked_shards"] < m2["shards"]
    # linked files share an inode with the base checkpoint's
    linked = [i for i in range(m2["shards"])
              if all(r["shard"] != i or r["name"] != "a"
                     for r in m2["leaves"])]
    shared = sum(
        os.stat(os.path.join(nxt, f"shard_{i}.npz")).st_ino
        == os.stat(os.path.join(base, f"shard_{i}.npz")).st_ino
        for i in linked)
    assert shared >= 1
    got, step = load_checkpoint(nxt, tree2)
    assert step == 2
    for k in tree2:
        assert torch.equal(got[k], tree2[k])
    # deleting the base must not tear the incremental snapshot
    shutil.rmtree(base)
    got2, _ = load_checkpoint(nxt, tree2)
    for k in tree2:
        assert torch.equal(got2[k], tree2[k])
    assert read_manifest(nxt)["linked_shards"] == m2["linked_shards"]


def test_incremental_save_of_an_unchanged_tree_links_every_shard(tmp_path):
    tree = _tree(1)
    base = str(tmp_path / "a")
    m1 = save_checkpoint(base, tree, shard_bytes=1500, hash_leaves=True)
    m2 = save_checkpoint(str(tmp_path / "b"), tree, shard_bytes=1500,
                         incremental_from=base)
    assert m2["shards"] == m1["shards"] > 2
    assert m2["linked_shards"] == m2["shards"]
    assert [r["hash"] for r in m2["leaves"]] == \
        [r["hash"] for r in m1["leaves"]]


def test_none_is_an_empty_subtree(tmp_path):
    tree = {"params": {"w": torch.ones(3)}, "ef": None, "step": 4}
    man = save_checkpoint(str(tmp_path / "c"), tree)
    assert [r["name"] for r in man["leaves"]] == ["params/w", "step"]
    got, _ = load_checkpoint(str(tmp_path / "c"), tree)
    assert got["ef"] is None and int(got["step"]) == 4


# -------------------------------------------------------- across packages
def _numpy_tree():
    rng = np.random.RandomState(3)
    bf = rng.randn(6, 5).astype(np.float32)
    return {"w": rng.randn(40, 9).astype(np.float32),
            "ids": rng.randint(-50, 50, size=(7,)).astype(np.int32),
            "norm": [rng.randn(9).astype(np.float32),
                     (rng.randn(3, 3).astype(np.float32),)],
            "half": bf,                     # saved as bf16 by both
            "scalar": np.float32(2.5)}


def _as_jax(tree):
    """``tree`` as jax arrays, ``half`` (if there) in bf16."""
    return {k: (jnp.asarray(v, jnp.bfloat16) if k == "half"
                else jax.tree.map(jnp.asarray, v)) for k, v in tree.items()}


def _as_torch(tree):
    """``tree`` as tensors, ``half`` (if there) in bf16."""
    out = tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    if "half" in out:
        out["half"] = out["half"].to(torch.bfloat16)
    return out


@pytest.mark.parametrize("shard_bytes", [512 * 1024 * 1024, 300])
def test_manifests_equal_across_packages(tmp_path, shard_bytes):
    tree = _numpy_tree()
    jm = jax_save_checkpoint(str(tmp_path / "jax"), _as_jax(tree), step=3,
                             shard_bytes=shard_bytes, hash_leaves=True,
                             extra={"k": 1})
    m = save_checkpoint(str(tmp_path / "port"), _as_torch(tree), step=3,
                        shard_bytes=shard_bytes, hash_leaves=True,
                        extra={"k": 1})
    assert m == jm
    assert read_manifest(str(tmp_path / "port")) == \
        read_manifest(str(tmp_path / "jax"))
    assert "bfloat16" in [r["dtype"] for r in m["leaves"]]
    assert all(len(r["hash"]) == 64 for r in m["leaves"])


def test_jax_checkpoint_loads_in_port_and_back(tmp_path):
    tree = {k: v for k, v in _numpy_tree().items() if k != "half"}
    jax_save_checkpoint(str(tmp_path / "j"), _as_jax(tree), step=9,
                        shard_bytes=400)
    got, step = load_checkpoint(str(tmp_path / "j"), _as_torch(tree))
    assert step == 9
    for a, b in zip(_leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    save_checkpoint(str(tmp_path / "p"), got, step=10, shard_bytes=400)
    back, step = jax_load_checkpoint(str(tmp_path / "p"), _as_jax(tree))
    assert step == 10
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jax_bf16_leaf_loads_with_the_same_bits(tmp_path):
    tree = _numpy_tree()
    jtree = _as_jax(tree)
    jax_save_checkpoint(str(tmp_path / "j"), jtree)
    got, _ = load_checkpoint(str(tmp_path / "j"), _as_torch(tree))
    assert got["half"].dtype == torch.bfloat16
    want = np.asarray(jtree["half"]).view(np.int16)
    np.testing.assert_array_equal(got["half"].view(torch.int16).numpy(), want)
    # the recorded difference: the JAX package's own load hands the leaf
    # back as a 2-byte void array
    back, _ = jax_load_checkpoint(str(tmp_path / "j"), jtree)
    assert np.asarray(back["half"]).dtype == np.dtype("V2")
    # and a port-written bf16 leaf has the same payload bytes
    save_checkpoint(str(tmp_path / "p"), got)
    jback, _ = jax_load_checkpoint(str(tmp_path / "p"), jtree)
    assert np.asarray(jback["half"]).tobytes() == want.tobytes()


# ---------------------------------------------------------- greedy tokens
def test_greedy_sample_reexport():
    assert greedy_sample is sampling_greedy


def test_generate_matches_jax():
    s = setup()
    prompt = np.random.RandomState(5).randint(1, s["cfg"].vocab_size,
                                              size=(3, 6))
    want = np.asarray(jax_generate(s["jmodel"], s["jparams"],
                                   jnp.asarray(prompt, jnp.int32), 10))
    got = generate(s["model"], s["params"], prompt, 10, device="cpu")
    assert got.shape == (3, 16) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    s = setup()
    with pytest.raises(RuntimeError, match="no CUDA"):
        generate(s["model"], s["params"], [[1, 2, 3]], 2)


QUICKSTART_STEPS = 5
QUICKSTART_PROMPT = [[1, 2, 3, 4]]


def _jax_quickstart(root):
    s = setup()
    comp = JaxStrategy.parse("bsp/allreduce/onebit@1", lr=0.05,
                             workers=1).compressor
    step = jax_make_train_step(
        s["jmodel"].loss_fn, JaxAdam(),
        precision=JaxPrecisionPolicy(compute_dtype="float32"),
        compressor=comp)
    batches = jax_make_lm_batches(JaxLMDataConfig(
        vocab_size=s["jcfg"].vocab_size, seq_len=64, batch_size=8))
    state, hist = jax_train_loop(
        step, JaxTrainState.create(s["jparams"], JaxAdam(), comp),
        lambda t: batches(t, 0), QUICKSTART_STEPS, log_every=1)
    trained = state["params"]
    ck = os.path.join(root, "ckpt")
    jax_save_checkpoint(ck, trained, step=QUICKSTART_STEPS)
    JaxModelRegistry(os.path.join(root, "registry")).register(
        "quickstart", ck, arch=s["jcfg"].name,
        metrics={"loss": hist[-1]["loss"]})
    restored, _ = jax_load_checkpoint(ck, trained)
    out = jax_generate(s["jmodel"], restored,
                       jnp.asarray(QUICKSTART_PROMPT), max_new_tokens=12)
    return np.asarray(out), hist


def test_quickstart_matches_jax(tmp_path):
    """examples/quickstart.py's default path end to end: Adam + onebit
    through make_train_step, save, register, reload, decode."""
    s = setup()
    want, jhist = _jax_quickstart(str(tmp_path / "jax"))
    model, params = s["model"], s["params"]
    layout = model.leaf_layout(params)
    comp = Strategy.parse("bsp/allreduce/onebit@1", lr=0.05,
                          workers=1).compressor
    step = make_train_step(model.loss_fn, Adam(),
                           precision=PrecisionPolicy(compute_dtype="float32"),
                           compressor=comp, layout=layout)
    batches = make_lm_batches(LMDataConfig(
        vocab_size=s["cfg"].vocab_size, seq_len=64, batch_size=8))
    state, hist = train_loop(step, TrainState.create(params, Adam(), comp,
                                                     layout),
                             lambda t: batches(t, 0), QUICKSTART_STEPS,
                             log_every=1)
    for a, b in zip(hist, jhist):
        assert abs(a["loss"] - b["loss"]) <= 1e-4
    trained = state["params"]
    root = str(tmp_path / "port")
    ck = os.path.join(root, "ckpt")
    save_checkpoint(ck, trained, step=QUICKSTART_STEPS)
    reg = ModelRegistry(os.path.join(root, "registry"))
    mid = reg.register("quickstart", ck, arch=s["cfg"].name,
                       metrics={"loss": hist[-1]["loss"]})
    assert mid == "quickstart:v0" and reg.get(mid)["checkpoint"] == ck
    restored, step_no = load_checkpoint(reg.get(mid)["checkpoint"], trained)
    assert step_no == QUICKSTART_STEPS
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(restored), _leaves(trained)))
    out = generate(model, restored, QUICKSTART_PROMPT, max_new_tokens=12,
                   device="cpu")
    assert out.shape == (1, 16)
    np.testing.assert_array_equal(out.numpy(), want)


def test_jax_model_checkpoint_decodes_the_same_tokens(tmp_path):
    s = setup()
    ck = str(tmp_path / "jax_model")
    jax_save_checkpoint(ck, s["jparams"], step=0, shard_bytes=200_000)
    # a tree of the JAX structure (stacked scan segments) on the port's side
    like = jax.tree.map(lambda x: torch.zeros(x.shape), s["jparams"])
    restored, _ = load_checkpoint(ck, like)
    params = from_jax_params(s["cfg"], restored)
    prompt = np.random.RandomState(9).randint(1, s["cfg"].vocab_size,
                                              size=(2, 5))
    want = np.asarray(jax_generate(s["jmodel"], s["jparams"],
                                   jnp.asarray(prompt, jnp.int32), 8))
    got = generate(s["model"], params, prompt, 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-large-v3"])
def test_family_checkpoints_load_across_packages(tmp_path, arch):
    """Reduced RecurrentGemma (4 layers: bf16 weights beside fp32 ``lam``
    and norms) and Whisper in bf16: a JAX-written checkpoint loads in the
    port with the same bits and carries over with ``from_jax_params``; the
    port's parameters, laid out by ``leaf_layout`` in the JAX structure,
    save to a checkpoint the JAX package loads with the same bits."""
    from repro_torch.models import whisper as W
    layers = dict(num_layers=4) if arch == "recurrentgemma-9b" else {}
    jcfg = jax_get_config(arch).reduced(**layers)
    cfg = get_config(arch).reduced(**layers)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0),
                                         dtype=jnp.bfloat16)
    model = build_model(cfg)
    carry = W.from_jax_params if cfg.is_encoder_decoder else from_jax_params
    jleaves = jax.tree.leaves(jparams)
    assert {str(x.dtype) for x in jleaves} == {"bfloat16", "float32"}

    def bits(x):
        a = np.asarray(x)
        return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)

    jax_save_checkpoint(str(tmp_path / "j"), jparams, step=1,
                        shard_bytes=100_000)
    like = jax.tree.map(lambda x: torch.zeros(
        x.shape, dtype=torch.bfloat16 if x.dtype == jnp.bfloat16
        else torch.float32), jparams)
    restored, step = load_checkpoint(str(tmp_path / "j"), like)
    params = carry(cfg, restored)
    layout = model.leaf_layout(params)
    assert step == 1 and len(layout.names) == len(jleaves)
    for i, x in enumerate(jleaves):
        got = layout.leaf(params, i)
        assert str(got.dtype)[6:] == str(x.dtype), layout.names[i]
        np.testing.assert_array_equal(
            got.view(torch.int16 if got.element_size() == 2
                     else torch.int32).numpy(), bits(x))
    tree = jax.tree_util.tree_unflatten(
        jax.tree.structure(jparams),
        [layout.leaf(params, i) for i in range(len(jleaves))])
    save_checkpoint(str(tmp_path / "p"), tree, step=2, shard_bytes=100_000)
    back, step = jax_load_checkpoint(str(tmp_path / "p"), jparams)
    assert step == 2
    for a, b in zip(jax.tree.leaves(back), jleaves):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
