"""The benchmark's command: one run of one cell.

    python3 perfbench/run.py --workload W --seed N --seconds S --trace 0|1

Everything is found by name: the cell ``W`` in ``BENCHMARK.json`` names a
configuration (its ``file``) and a traffic mix (``traffic/<mix>.json``,
whose ``kind`` picks the driver, ``train`` or ``serve``); the cell's
correctness limits are ``limits/<W>.json``; each per-layer metric is read
by ``metrics/<metric>.py``.  A run prints the card's name, power limit and
clocks and the kernel library's one-time build on standard error first,
then the numbers compared with their limits as the last lines there, and
as the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and ``checks`` last.

With ``--trace 0`` the metrics are the cell's end-to-end ones; with
``--trace 1`` the window runs as before with ``torch.profiler`` over a
part of it (the mix's ``trace_seconds``, in the middle), and the metrics
are the cell's per-layer ones.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRIVERS = {"train": "perfbench.train", "serve": "perfbench.serve"}


# ------------------------------------------------------------- by name
def manifest() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def resolve(man: Dict, workload: str) -> SimpleNamespace:
    """The cell ``workload`` with its configuration, mix, limits and the
    per-layer metrics that read it."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return SimpleNamespace(
        cell=cell, config=load_json(ROOT / conf["file"]),
        mix=load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{workload}.json"),
        end_to_end=e2e, per_layer=layer)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peaks(kind: str) -> Optional[Dict]:
    """The published peaks of the card called ``kind`` (None if unknown)."""
    return load_json(HERE / "peaks.json").get(kind)


# ----------------------------------------------------------- the card
def card_line(device) -> str:
    import torch
    name = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        smi = f"nvidia-smi not read ({exc})"
    return f"card: {name}; {smi}"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark refuses
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# -------------------------------------------------------------- a run
def per_layer(res: SimpleNamespace, metrics) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"]).read(res)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(c: SimpleNamespace, seed: int, seconds: float, trace: bool,
             device, started: float) -> SimpleNamespace:
    """Drive the cell once on ``device`` (the tests drive it on the CPU at
    a reduced size)."""
    driver = importlib.import_module(DRIVERS[c.mix["kind"]])
    res = driver.run(c.config, c.mix, c.limits, seed, seconds, trace, device,
                     started)
    res.peaks = peaks(device_kind(device))
    res.load_kernel = lambda name: load_module("kernels", name)
    res.correct = verdict({name: v for name, v, _ in res.checks}, c.limits)
    return res


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """``correct``: every number the cell's limits name reads at or under
    its limit (the controls are judged by the same rule)."""
    return all(readings[name] <= lim for name, lim in limits.items())


def device_kind(device) -> str:
    import torch
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def result_line(c, res, trace: bool, device) -> Dict:
    if trace:
        metrics = per_layer(res, c.per_layer)
    else:
        metrics = {m["name"]: {"value": (res.setup_s if m["name"] == "setup_s"
                                         else res.end_to_end[m["name"]]),
                               "unit": m["unit"]} for m in c.end_to_end}
    dev = {"platform": "gpu", "kind": device_kind(device),
           "count": c.cell["chips"], "memory_peak_bytes": int(res.memory_peak)}
    out = {"correct": bool(res.correct), "attempted": int(res.attempted),
           "failed": int(res.failed), "metrics": metrics, "device": dev}
    if trace and res.trace is not None:
        from perfbench.trace import breakdown, busy_s
        dev["busy_s"] = busy_s(res.trace)
        dev["window_s"] = res.trace.window_s
        out["breakdown"] = breakdown(res.trace)
    out["checks"] = {name: {"value": _finite(v), "limit": lim}
                     for name, v, lim in res.checks}
    return out


def main(argv, started: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = resolve(manifest(), args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < c.cell["chips"]:
        print(f"perfbench: the cell needs {c.cell['chips']} CUDA device(s); "
              f"this host has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(card_line(device), file=sys.stderr, flush=True)
    from repro_torch.kernels import build
    t = time.perf_counter()
    fresh = not (build.build_dir() / build.LIB_NAME).exists()
    build.library()
    print(f"kernel library: {build.build_dir()} "
          f"{'built' if fresh else 'found'} in "
          f"{time.perf_counter() - t:.3f} s (part of setup_s)",
          file=sys.stderr, flush=True)

    res = run_cell(c, args.seed, args.seconds, bool(args.trace), device,
                   started)
    line = result_line(c, res, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: refused modules loaded: {bad}", file=sys.stderr)
        return 3
    print("set-up stages (s from process start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in res.stages.items()), file=sys.stderr)
    read = getattr(res, "checked_tokens", None)
    print(f"window {res.window_s:.3f} s, set-up {res.setup_s:.3f} s, "
          f"reference {res.reference_s:.3f} s, attempted {res.attempted}"
          + (f", served tokens checked {read}" if read is not None else ""),
          file=sys.stderr)
    for name, v, lim in res.checks:
        print(f"check {name}: {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


def _finite(v: float) -> float:
    """A compared number as JSON holds it: a reading that could not be
    taken (no request finished) is the largest float, past any limit."""
    return v if math.isfinite(v) else sys.float_info.max
