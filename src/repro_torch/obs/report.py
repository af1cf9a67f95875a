"""Human-readable trace report (the JAX package's ``obs/report.py``):
``python -m repro_torch.obs.report trace.json`` (docs/observability.md,
"Analysis & SLOs").

Renders every section ``obs.analyze.analyze`` extracts — step-time
attribution, comm overlap efficiency, pipeline bubbles, serve latency —
as aligned text; ``--json`` dumps the raw analysis dict instead, and
``--slo SPEC`` (repeatable) additionally evaluates serve objectives via
``obs.slo.evaluate_trace``.  The launchers expose the same rendering as
``--report`` after a traced run.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from repro_torch.obs.analyze import ATTRIBUTION_CATEGORIES, analyze


def _fmt_t(seconds: float, basis: str) -> str:
    if basis == "ticks":
        return f"{seconds:10.0f}tk"
    return f"{seconds * 1e3:10.3f}ms"


def render(trace: dict, slos: Sequence[str] = ()) -> str:
    a = analyze(trace)
    out: List[str] = []
    val = a["validation"]
    out.append(f"trace: {val['events']} events, {val['spans']} spans, "
               f"{val['instants']} instants, {val['counters']} counter "
               f"samples, depth {val['max_depth']}")
    for err in val.get("errors", []):
        out.append(f"  STRUCTURE: {err}")

    attr = a["attribution"]
    if attr:
        out.append(f"\nstep attribution ({attr['basis']} basis, "
                   f"{len(attr['steps'])} steps):")
        out.append("  step      total    compute       comm   snapshot"
                   "      stall  attributed")
        for r in attr["steps"]:
            out.append(
                f"  {str(r['step']):>4} " +
                " ".join(_fmt_t(r[k], attr["basis"])
                         for k in ("total",) + ATTRIBUTION_CATEGORIES)
                + f"  {r['attributed_pct']:6.1f}%")
        fr = attr["fractions"]
        out.append("  totals: " + "  ".join(
            f"{k} {100 * fr[k]:.1f}%" for k in ATTRIBUTION_CATEGORIES))

    ov = a["overlap"]
    if ov:
        out.append(f"\ncomm overlap efficiency "
                   f"(mean {ov['efficiency_mean']:.3f}, bounds "
                   f"{'OK' if ov['all_in_bounds'] else 'VIOLATED'}):")
        for r in ov["exchanges"]:
            out.append(
                f"  step {str(r['step']):>4}: no-overlap "
                f"{r['no_overlap_us']:.1f}us >= issue "
                f"{r['issue_overlap_us']:.1f}us >= tictac "
                f"{r['tictac_overlap_us']:.1f}us  "
                f"eff {r['efficiency']:.3f}")

    pp = a["pipeline"]
    if pp:
        out.append(f"\npipeline bubbles (max rel err "
                   f"{pp['rel_err_max']:.3f}):")
        for r in pp["pipes"]:
            out.append(
                f"  step {str(r['step']):>4}: S={r['stages']} "
                f"M={r['micro']} ticks={r['ticks']}  measured "
                f"{r['measured_bubble']:.4f} vs analytic "
                f"{r['analytic_bubble']:.4f} "
                f"({r['bubble_ticks']}/{r['bubble_ticks'] + r['active_ticks']}"
                f" stage-ticks idle)")

    sv = a["serve"]
    if sv:
        out.append(f"\nserve: {sv['requests']} requests  "
                   f"ttft p50/p99 {sv['ttft_p50']:.2f}/{sv['ttft_p99']:.2f}"
                   f"  tpot p50/p99 {sv['tpot_p50']:.2f}/"
                   f"{sv['tpot_p99']:.2f}  stalls {sv['admission_stalls']}"
                   f"  kv saturation {100 * sv['kv_saturated_frac']:.0f}%")
        if sv["slo_burn_alerts"]:
            out.append(f"  slo_burn alerts on trace: "
                       f"{sv['slo_burn_alerts']}")

    if slos:
        from repro_torch.obs.slo import evaluate_trace
        ev = evaluate_trace(trace, slos)
        out.append(f"\nSLO evaluation ({ev['observations']} observations,"
                   f" {len(ev['alerts'])} alert transition(s)):")
        for r in ev["evaluation"]:
            out.append(
                f"  {r['objective']:>16}: burn long/short "
                f"{r['burn_long']:.2f}/{r['burn_short']:.2f}"
                f"{'  FIRING' if r['firing'] else ''}")
        for al in ev["alerts"]:
            out.append(f"  alert at t={al['t']}: "
                       + ", ".join(al["objectives"]))

    if not any((attr, ov, pp, sv)):
        out.append("\n(no analyzable sections: trace has no train, "
                   "pipeline, or serve spans)")
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Analyze a recorded Chrome trace "
                    "(docs/observability.md).")
    ap.add_argument("trace", help="trace JSON written by obs.tracing")
    ap.add_argument("--json", action="store_true",
                    help="dump the raw analysis dict as JSON")
    ap.add_argument("--slo", action="append", default=[],
                    metavar="SPEC",
                    help="evaluate a serve objective, e.g. ttft_p99<8 "
                         "(repeatable)")
    args = ap.parse_args(argv)
    from repro_torch.obs.trace import load_trace
    trace = load_trace(args.trace)
    if args.json:
        out = analyze(trace)
        if args.slo:
            from repro_torch.obs.slo import evaluate_trace
            out["slo"] = evaluate_trace(trace, args.slo)
        print(json.dumps(out, sort_keys=True, default=str))
    else:
        print(render(trace, slos=args.slo))
    return 0


if __name__ == "__main__":
    sys.exit(main())
