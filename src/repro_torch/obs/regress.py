"""Cross-PR benchmark regression gate (the JAX package's
``obs/regress.py``).

Each PR of a benchmark lineage commits a ``BENCH_<lineage>pr<N>.json``
snapshot — JSON-line rows of its headline benchmark; this module diffs
them so drift fails loudly (``tools/torch_bench_regress.py``).  The
lineage is a parameter: the port's snapshots are
``BENCH_torch_pr<N>.json`` (the default), kept apart from the JAX
package's ``BENCH_pr<N>.json``.

Rows are **keyed** by their identity fields — ``bench`` plus every
string/bool field (strategy spec, codec, backend, policy, ...) plus a
whitelist of integer shape fields — and compared only on the metrics in
``METRIC_BANDS``.  Each band declares how a metric may move:

  ("rel",  tol, "lower")    relative drift; fails when the new value is
                            worse (direction) by more than tol
  ("abs",  tol, dir)        absolute drift band
  ("range", (lo, hi), _)    the value itself must sit inside [lo, hi]
                            (applied to current rows only — e.g. the
                            tracing-overhead sanity band)

Wall-clock metrics (``wall_s``, ``*_step_us``, ``us_per_call_interp``)
are deliberately *not* banded: they measure the host the bench ran on,
not the code.

The newest snapshot is "current" by default; each of its keyed rows is
compared against the most recent older snapshot containing the same
key.  Keys that appear in only one snapshot are skipped (benches come
and go), but every comparison that *can* run, runs.  Stdlib-only.
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

# integer fields that identify a bench cell rather than measure it
ID_INT_FIELDS = frozenset({
    "workers", "slots", "tp", "page_size", "requests", "bucket_passes",
    "stages", "micro", "max_new_tokens", "interleave",
})

# metric -> (kind, tolerance, direction).  direction "lower" = smaller
# is better (regression = grew), "higher" = larger is better.
METRIC_BANDS: Dict[str, Tuple[str, Any, Optional[str]]] = {
    "wire_bytes_per_step": ("rel", 0.01, "lower"),
    "loss_last": ("abs", 0.75, "lower"),
    "modeled_no_overlap_us": ("rel", 0.25, "lower"),
    "modeled_tictac_overlap_us": ("rel", 0.25, "lower"),
    "p50_first_token": ("rel", 0.10, "lower"),
    "p99_first_token": ("rel", 0.10, "lower"),
    "p50_per_token": ("rel", 0.10, "lower"),
    "p99_per_token": ("rel", 0.10, "lower"),
    "tokens_per_s": ("rel", 0.10, "higher"),
    "tpu_roofline_us": ("rel", 0.01, "lower"),
    "traced_overhead_pct": ("range", (-5.0, 50.0), None),
}

LINEAGE = r"BENCH_torch_pr(\d+)\.json"      # the port's snapshots


def row_key(row: dict) -> Tuple:
    """The identity of a bench row: every string/bool field plus the
    whitelisted shape ints, sorted for stability."""
    return tuple(sorted(
        (k, v) for k, v in row.items()
        if isinstance(v, (str, bool)) or k in ID_INT_FIELDS))


def load_rows(path: str) -> List[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                rows.append(json.loads(line))
    return rows


def find_bench_files(root: str, pattern: str = LINEAGE) -> List[str]:
    """Committed snapshots whose file name matches ``pattern`` (its group
    1 the PR number), sorted by PR number."""
    rx = re.compile(pattern)
    keyed = []
    for p in glob.glob(os.path.join(root, "BENCH_*.json")):
        m = rx.fullmatch(os.path.basename(p))
        if m:
            keyed.append((int(m.group(1)), p))
    return [p for _, p in sorted(keyed)]


def _check_pair(key: Tuple, metric: str, old: float, new: float,
                band: Tuple, tag_old: str, tag_new: str) -> Optional[dict]:
    kind, tol, direction = band
    if kind == "range":
        return None                      # range checks are per-row
    worse = (new - old) if direction == "lower" else (old - new)
    if kind == "rel":
        scale = abs(old) if old else 1.0
        drift = worse / scale
    else:
        drift = worse
    if drift > tol:
        return dict(key=dict(key), metric=metric, old=old, new=new,
                    drift=round(drift, 6), tol=tol, kind=kind,
                    direction=direction, old_snapshot=tag_old,
                    new_snapshot=tag_new)
    return None


def _check_range(key: Tuple, metric: str, value: float, band: Tuple,
                 tag: str) -> Optional[dict]:
    lo, hi = band[1]
    if not lo <= value <= hi:
        return dict(key=dict(key), metric=metric, old=None, new=value,
                    drift=None, tol=[lo, hi], kind="range",
                    direction=None, old_snapshot=None, new_snapshot=tag)
    return None


def compare(lineage: Sequence[Tuple[str, Sequence[dict]]],
            current: Optional[Tuple[str, Sequence[dict]]] = None) -> dict:
    """``lineage`` is [(tag, rows), ...] oldest-first.  ``current``
    defaults to the newest lineage entry (which is then excluded from
    the history it is compared against).  Returns the gate report:
    ``passed``, the ``violations`` list, and coverage counts."""
    lineage = list(lineage)
    if current is None:
        if not lineage:
            raise ValueError("no bench snapshots to compare")
        current = lineage[-1]
        lineage = lineage[:-1]
    cur_tag, cur_rows = current

    history: List[Tuple[str, Dict[Tuple, dict]]] = [
        (tag, {row_key(r): r for r in rows}) for tag, rows in lineage]

    violations: List[dict] = []
    compared = range_checked = 0
    for row in cur_rows:
        key = row_key(row)
        baseline = None
        for tag, keyed in reversed(history):
            if key in keyed:
                baseline = (tag, keyed[key])
                break
        for metric, band in METRIC_BANDS.items():
            if metric not in row or not isinstance(row[metric],
                                                   (int, float)):
                continue
            if band[0] == "range":
                range_checked += 1
                v = _check_range(key, metric, float(row[metric]), band,
                                 cur_tag)
                if v:
                    violations.append(v)
                continue
            if baseline is None or metric not in baseline[1]:
                continue
            compared += 1
            v = _check_pair(key, metric, float(baseline[1][metric]),
                            float(row[metric]), band, baseline[0],
                            cur_tag)
            if v:
                violations.append(v)
    return dict(passed=not violations, violations=violations,
                compared=compared, range_checked=range_checked,
                current=cur_tag, snapshots=[t for t, _ in history],
                current_rows=len(cur_rows))


def run_gate(root: str, current_path: Optional[str] = None,
             pattern: str = LINEAGE) -> dict:
    """The CLI entry: discover the lineage's snapshots under ``root``,
    compare the newest (or ``current_path``) against the rest."""
    paths = find_bench_files(root, pattern)
    if not paths:
        raise FileNotFoundError(f"no snapshot matching {pattern} under "
                                f"{root}")
    lineage = [(os.path.basename(p), load_rows(p)) for p in paths]
    current = None
    if current_path is not None:
        current = (os.path.basename(current_path), load_rows(current_path))
    return compare(lineage, current)


def format_report(report: dict) -> str:
    lines = [f"bench-regress: {report['current']} vs "
             f"{len(report['snapshots'])} older snapshot(s) "
             f"({report['compared']} metric comparisons, "
             f"{report['range_checked']} range checks)"]
    for v in report["violations"]:
        ident = {k: val for k, val in v["key"].items()
                 if k in ("bench", "strategy", "kernel", "policy",
                          "backend", "shape")}
        if v["kind"] == "range":
            lines.append(
                f"  FAIL {v['metric']}={v['new']} outside {v['tol']} "
                f"[{v['new_snapshot']}] {ident}")
        else:
            lines.append(
                f"  FAIL {v['metric']}: {v['old']} -> {v['new']} "
                f"(drift {v['drift']} > {v['tol']} {v['kind']}, "
                f"{v['old_snapshot']} -> {v['new_snapshot']}) {ident}")
    lines.append("bench-regress: " +
                 ("OK" if report["passed"] else
                  f"{len(report['violations'])} violation(s)"))
    return "\n".join(lines)
