"""The port's serving engine against the JAX package's.

The same 6 requests (two prompt lengths, Poisson arrivals) go through the
JAX ``ServeEngine`` (fp32, ``attn_backend="ref"``) and the port's on the
CPU, with the JAX weights carried over.  Greedy outputs must agree token
for token and the virtual-clock metrics exactly, for the contiguous cache
and for a paged pool small enough to stall admission.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve.autoscale import poisson_trace as jax_poisson_trace
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.request import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.launch.serve import main as launch_serve
from repro_torch.models import build_model
from repro_torch.models.transformer import from_jax_params
from repro_torch.serve.autoscale import poisson_trace
from repro_torch.serve.cache import BlockAllocator
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.request import Request, SamplingParams
from repro_torch.serve.sampling import sample_tokens

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")
CLOCK_METRICS = ("clock", "decode_iterations", "prefill_groups",
                 "p50_first_token", "p99_first_token", "generated_tokens",
                 "admission_stalls", "completed")
_CACHE = {}


def models():
    if not _CACHE:
        jcfg = dataclasses.replace(
            jax_get_config("tinyllama-1.1b").reduced(num_kv_heads=2),
            attn_backend="ref")
        cfg = get_config("tinyllama-1.1b").reduced(num_kv_heads=2)
        jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
        _CACHE.update(
            jax=(jax_build_model(jcfg), jparams),
            torch=(build_model(cfg),
                   from_jax_params(cfg, jax.tree.map(np.array, jparams))))
    return _CACHE


def _requests(cls):
    rng = np.random.RandomState(7)
    arrivals = [0.0] + poisson_trace(0.7, 20.0, seed=3, max_requests=5)
    lens = [5, 7, 5, 7, 7, 5]
    return [cls(rid=i, prompt=[int(t) for t in rng.randint(1, 512, lens[i])],
                max_new_tokens=4 + i % 3, arrival=arrivals[i])
            for i in range(6)]


def test_poisson_trace_matches_jax():
    assert poisson_trace(0.7, 20.0, seed=3, max_requests=5) == \
        jax_poisson_trace(0.7, 20.0, seed=3, max_requests=5)


@pytest.mark.parametrize("layout", [
    dict(),                                        # contiguous
    dict(page_size=4, num_pages=7),                # paged, stalls admission
])
def test_engine_matches_jax(layout):
    jmodel, jparams = models()["jax"]
    model, params = models()["torch"]
    scfg = dict(slots=3, max_len=12, **layout)
    jreqs, reqs = _requests(JaxRequest), _requests(Request)
    jm = JaxServeEngine(jmodel, jparams, JaxServeConfig(
        cache_dtype=jnp.float32, compute_dtype=jnp.float32, **scfg)).run(jreqs)
    m = ServeEngine(model, params, ServeConfig(**scfg), device="cpu").run(reqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    for key in CLOCK_METRICS:
        assert m[key] == jm[key], key
    assert m["completed"] == 6
    if layout:
        assert m["admission_stalls"] > 0


def test_sampling_topk1_is_greedy_and_seeded():
    lg = torch.from_numpy(np.random.RandomState(0).randn(3, 40)
                          .astype(np.float32))
    greedy = lg[:, :32].argmax(-1)
    seeds, idx = np.array([1, 2, 3]), np.array([0, 5, 9])
    ones = np.ones(3, np.float32)
    top1 = sample_tokens(lg, 32, seeds, idx, ones, np.ones(3, np.int64))
    assert torch.equal(top1, greedy)
    a = sample_tokens(lg, 32, seeds, idx, ones, np.zeros(3, np.int64))
    b = sample_tokens(lg, 32, seeds, idx, ones, np.zeros(3, np.int64))
    assert torch.equal(a, b) and int(a.max()) < 32


def test_block_allocator_reuse_and_errors():
    a = BlockAllocator(num_pages=8, reserved=1)     # 7 usable
    p1 = a.alloc(4)
    assert a.free_pages == 3 and not a.can_alloc(4)
    with pytest.raises(MemoryError):
        a.alloc(4)
    a.free(p1)
    assert sorted(a.alloc(7)) == list(range(1, 8))
    with pytest.raises(ValueError):
        a.free([0])                                 # null page is reserved
    with pytest.raises(ValueError):
        BlockAllocator(num_pages=1)


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    model, params = models()["torch"]
    with pytest.raises(RuntimeError, match="no CUDA"):
        ServeEngine(model, params, ServeConfig())


def test_oversized_request_rejected():
    model, params = models()["torch"]
    eng = ServeEngine(model, params, ServeConfig(slots=1, max_len=8,
                                                 page_size=4), device="cpu")
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=32,
                       sampling=SamplingParams()))
    with pytest.raises(ValueError, match="can never be served"):
        eng.run()


def test_port_imports_no_jax_and_no_repro():
    """Every module of repro_torch imports without pulling in jax or the
    JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert len(names) > 20, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]


def test_launcher_smoke_on_cpu(capsys):
    m = launch_serve(["--smoke", "--device", "cpu", "--dtype", "f32", "--requests",
              "3", "--rate", "0.5", "--pages", "4", "--max-new", "3"])
    assert m["completed"] == 3 and m["generated_tokens"] == 9
    assert "3 requests, 9 tokens" in capsys.readouterr().out
