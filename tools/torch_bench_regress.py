"""The port's cross-PR benchmark regression gate: diffs the newest
committed ``BENCH_torch_pr<N>.json`` snapshot (or a fresh rows file via
``--current``) against the older ones on the keyed deterministic metrics
of ``repro_torch.obs.regress.METRIC_BANDS``, and exits 1 on out-of-band
drift.  ``--pattern`` reads another lineage (e.g.
``'BENCH_pr(\\d+)\\.json'``).

  PYTHONPATH=src python tools/torch_bench_regress.py
  PYTHONPATH=src python tools/torch_bench_regress.py --current fresh.json
  PYTHONPATH=src python tools/torch_bench_regress.py --json
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.obs.regress import LINEAGE, format_report, run_gate  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Cross-PR BENCH snapshot regression gate of the port.")
    ap.add_argument("--root", default=REPO,
                    help="directory holding the snapshots")
    ap.add_argument("--pattern", default=LINEAGE,
                    help="file-name regex of the lineage (group 1: the PR)")
    ap.add_argument("--current", default=None, metavar="ROWS.json",
                    help="compare this fresh rows file against the full "
                         "lineage instead of the newest snapshot")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw report dict as JSON")
    args = ap.parse_args(argv)
    report = run_gate(args.root, current_path=args.current,
                      pattern=args.pattern)
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(format_report(report))
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
