"""Roofline analysis from the dry-run's records (the JAX package's
``launch/roofline.py``), with one H100's constants.

Per (arch x shape x mesh) record:
  compute term    = FLOPs / chips / peak bf16 FLOP/s
  memory term     = bytes accessed / chips / HBM bandwidth (unfused bound)
  collective term = ring-weighted collective bytes / NVLink bandwidth

plus MODEL_FLOPS = 6*N*D (training; 2*N_active*D for prefill and decode)
and the useful-compute ratio MODEL_FLOPS / FLOPs.

How the terms are counted differs from the reference's: its cost is the
per-device HLO module's, replicated work included; the port's
(``launch.cost``) is the whole step's, counted once on meta, and is
divided evenly over the mesh's chips, as if no work were replicated.
The collective term is the record's per-device ``traffic_weighted``
(``launch.spmd``: the step partitioned by DTensor over a fake process
group of the mesh's size) over one H100's NVLink bandwidth
(``launch.mesh.NVLINK_BW``), and ``dominant`` weighs it with the other
two.  Where a record's ``collectives`` is null (a step DTensor cannot
partition yet: its ``collectives_error``), so is the term, and
``dominant`` names the larger of compute and memory and says so.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--dir DIR]
Writes results/roofline_torch.json and prints the table.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

RESULTS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                       "..", "results"))


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic useful FLOPs for the whole step (all chips)."""
    cfg = ARCHS[arch]
    shape = INPUT_SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def analyze_record(rec: Dict, chips: int) -> Dict:
    """The roofline terms of one ok record, in seconds per step."""
    cost = rec.get("cost", {})
    coll = rec.get("collectives")
    flops = cost.get("flops", 0.0)
    nbytes = cost.get("bytes_accessed", 0.0)
    terms = {"compute_s": flops / chips / PEAK_FLOPS_BF16,
             "memory_s": nbytes / chips / HBM_BW}
    dominant = max(terms, key=terms.get).replace("_s", "")
    if coll is None:
        t_coll = None
        dominant += " (no collectives counted)"
    else:
        t_coll = coll.get("traffic_weighted", 0.0) / NVLINK_BW
        terms["collective_s"] = t_coll
        dominant = max(terms, key=terms.get).replace("_s", "")
    mf = model_flops(rec["arch"], rec["shape"])
    return {
        "compute_s": round(terms["compute_s"], 6),
        "memory_s": round(terms["memory_s"], 6),
        "collective_s": None if t_coll is None else round(t_coll, 6),
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": round(mf / max(flops, 1.0), 4),
        "bound_step_s": round(max(terms.values()), 6),
        "counted": "whole step over chips, no replicated work",
    }


def _rank(rec: Dict, path: str) -> int:
    """Cost-source quality: probe (per-layer exact, extrapolated) >
    unrolled > scanned."""
    if "__tp_only" in path or "__moehints" in path:
        return -1      # hillclimb variants never replace the baseline
    if rec.get("probe"):
        return 3
    if rec.get("unrolled") or path.endswith("__unrolled.json"):
        return 2
    return 1


def load_all(dir_: str) -> List[Dict]:
    """One record per (arch, shape, mesh): the full-depth record is the
    fits evidence; cost/collectives come from the best available
    measurement (probe > unrolled > full-depth).  A pair that exceeds one
    card still has its mesh's cost."""
    base: Dict = {}
    best: Dict = {}
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            rec = json.load(f)
        key = (rec.get("arch"), rec.get("shape"), rec.get("mesh"))
        r = _rank(rec, p)
        if r == 1:
            base[key] = rec
        if r > 0 and rec.get("status") in ("ok", "skipped"):
            if key not in best or r > best[key][0]:
                best[key] = (r, rec)
    out = []
    for key in sorted(set(base) | set(best),
                      key=lambda t: (str(t[0]), str(t[1]), str(t[2]))):
        rec = dict(base.get(key) or best[key][1])
        if key in best and best[key][0] > 1 and rec.get("status") in (
                "ok", "exceeds_card"):
            src = best[key][1]
            rec["cost"] = src.get("cost", rec.get("cost"))
            rec["collectives"] = src.get("collectives",
                                         rec.get("collectives"))
            rec["cost_source"] = "probe" if src.get("probe") else "unrolled"
        out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(RESULTS, "dryrun_torch"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out_path = args.out or os.path.join(os.path.dirname(args.dir),
                                        "roofline_torch.json")

    rows = []
    for rec in load_all(args.dir):
        if rec.get("status") not in ("ok", "exceeds_card") or \
                "cost" not in rec:
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec.get("mesh"),
                         "status": rec.get("status") if rec.get(
                             "status") != "ok" else "no cost",
                         "reason": rec.get("reason", rec.get("error", ""))})
            continue
        chips = 512 if rec["mesh"] == "2x16x16" else 256
        row = {"arch": rec["arch"], "shape": rec["shape"],
               "mesh": rec["mesh"], "status": "ok", "chips": chips,
               "card": rec["status"]}
        row.update(analyze_record(rec, chips))
        rows.append(row)

    with open(out_path, "w") as f:
        json.dump(rows, f, indent=1)

    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':8s} {'compute':>10s} "
           f"{'memory':>10s} {'collect':>10s} {'dominant':>10s} "
           f"{'useful':>7s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        if r.get("status") != "ok":
            print(f"{r['arch']:24s} {r['shape']:12s} {str(r.get('mesh')):8s} "
                  f"{r.get('status'):>10s}  {r.get('reason', '')[:40]}")
            continue
        coll = ("      null" if r["collective_s"] is None
                else f"{r['collective_s']:10.4f}")
        print(f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:8s} "
              f"{r['compute_s']:10.6f} {r['memory_s']:10.6f} {coll} "
              f"{r['dominant'].split()[0]:>10s} {r['useful_ratio']:7.3f}")
    nulls = sum(r.get("status") == "ok" and r["collective_s"] is None
                for r in rows)
    print(f"\ncollective term: per-device ring traffic of the DTensor-"
          f"partitioned step over NVLink; null in {nulls} record(s) whose "
          f"step DTensor cannot partition yet (collectives_error);\n"
          f"compute and memory terms are the whole step's count over the "
          f"chips (no replicated work)")
    print(f"\nwrote {out_path}")


if __name__ == "__main__":
    main()
