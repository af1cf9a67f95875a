"""The JAX reference's collectives beside the port's: one script, compiled
in a subprocess of 512 host devices, that ``tests/test_torch_spmd.py``
runs and that this file runs to print the side-by-side table.

Under JAX 0.9 ``jax.make_mesh`` makes mesh axes of the Explicit type, and
the reference's own dry-run fails at its embedding gather; the script
replaces ``repro.launch.dryrun.make_production_mesh`` with the same mesh
of Auto axes (nothing under ``src/repro`` changes).  It compiles each
primitive of ``prims`` (a redistribution of a ``[1024, 2048]`` tensor,
or its product with a ``[2048, 2048]`` one, in fp32 and bf16, on 16 x
16) and ``probe_pair`` of each shape, and prints their per-device
collective bytes (``repro.launch.hlo_analysis.collective_bytes``).

Usage: PYTHONPATH=src python tests/torch_spmd_ref.py [--multi-pod]
           [--arch tinyllama-1.1b] [--cache-policy attn_hints_seq]
prints MiB per device by kind, the port's / the reference's, with the
port's roofline terms (``repro_torch.launch.roofline``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "traffic_weighted")

REF_SCRIPT = r'''
import json, tempfile
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
import repro.launch.dryrun as D
from repro.launch.hlo_analysis import collective_bytes

def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(AxisType.Auto,) * len(shape))

D.make_production_mesh = auto_mesh
mesh = auto_mesh()
out = {"prims": {}, "probes": {}}
for dtype in ("float32", "bfloat16"):
    for name, (ins, spec) in %(prims)r.items():
        shapes = [(1024, 2048), (2048, 2048)][:len(ins)]
        args = [jax.ShapeDtypeStruct(s, getattr(jnp, dtype),
                                     sharding=NamedSharding(mesh, P(*sp)))
                for s, sp in zip(shapes, ins)]
        fn = (lambda a, b: a @ b) if len(ins) == 2 else (lambda a: a * 1)
        c = jax.jit(fn, out_shardings=NamedSharding(mesh, P(*spec))).lower(
            *args).compile()
        out["prims"][name + ":" + dtype] = collective_bytes(c.as_text())
for s in %(shapes)r:
    rec = D.probe_pair(%(arch)r, s, %(multi_pod)r, tempfile.mkdtemp(),
                       force=True, cache_policy=%(policy)r)
    assert rec["status"] == "ok", rec.get("error")
    out["probes"][s] = {k: rec[k] for k in
                        ("collectives", "collectives_n1", "collectives_n2")}
print("JSON" + json.dumps(out))
'''


def ref_script(arch: str, shapes, multi_pod: bool = False,
               policy: str = "attn_hints_seq", prims=None) -> str:
    """``REF_SCRIPT`` for these probes (and primitives)."""
    return REF_SCRIPT % {"arch": arch, "shapes": tuple(shapes),
                         "multi_pod": multi_pod, "policy": policy,
                         "prims": prims or {}}


def parse(stdout: str):
    return json.loads(stdout.split("JSON", 1)[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--cache-policy", default="attn_hints_seq")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import analyze_record

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-c", ref_script(args.arch, SHAPES, args.multi_pod,
                                          args.cache_policy)],
        env=env, capture_output=True, text=True, check=True)
    ref = parse(res.stdout)["probes"]
    chips = 512 if args.multi_pod else 256
    mib = lambda v: f"{v / 2**20:.2f}"              # noqa: E731
    print(f"{args.arch}, {'2x16x16' if args.multi_pod else '16x16'}, "
          f"cache policy {args.cache_policy}: MiB per device, port / "
          f"reference")
    print("| pair | " + " | ".join(KINDS) + " | port dominant (collective "
          "s / memory s) |")
    print("|---" * (len(KINDS) + 2) + "|")
    out = tempfile.mkdtemp()
    for s in SHAPES:
        rec = dryrun.probe_pair(args.arch, s, args.multi_pod, out,
                                force=True, cache_policy=args.cache_policy)
        got, want = rec["collectives"], ref[s]["collectives"]
        row = analyze_record(rec, chips)
        cells = [f"{mib(got[k])} / {mib(want[k])}" for k in KINDS]
        print(f"| {s} | " + " | ".join(cells) + f" | {row['dominant']} "
              f"({row['collective_s']:.6f} / {row['memory_s']:.6f}) |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
