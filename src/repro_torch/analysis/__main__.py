"""CLI: ``python -m repro_torch.analysis`` — run the static-analysis gate.

Examples::

    python -m repro_torch.analysis --all            # every pass, full scope
    python -m repro_torch.analysis model --quick    # fast model-check subset
    python -m repro_torch.analysis model trace --protocol lrscwait
    python -m repro_torch.analysis --all --json report.json

Exit status 0 = all checks green; 1 = findings (the CI gate).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.analysis import PASSES, run_passes
from repro_torch.analysis.report import all_findings, fail_fast, summarize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="protocol model checker, trace-safety checks and "
                    "integer-range analyzer")
    ap.add_argument("passes", nargs="*", choices=[*PASSES, []],
                    help=f"passes to run ({', '.join(PASSES)}); "
                         f"default with --all: every pass")
    ap.add_argument("--all", action="store_true",
                    help="run every pass")
    ap.add_argument("--protocol", action="append", default=None,
                    metavar="NAME",
                    help="restrict model/trace passes to this protocol "
                         "(repeatable)")
    ap.add_argument("--quick", action="store_true",
                    help="small-scope subset (CI smoke / unit tests)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the full report as JSON")
    args = ap.parse_args(argv)
    sel = list(args.passes) or None
    if args.all or sel is None:
        sel = list(PASSES)

    t0 = time.perf_counter()
    reports = run_passes(sel, quick=args.quick, protocols=args.protocol)
    wall = time.perf_counter() - t0
    findings = all_findings(reports)

    print(f"repro_torch.analysis: {', '.join(sel)}"
          + (" (quick)" if args.quick else ""))
    print(summarize(reports))
    states = sum(r.stats.get("states", 0) for r in reports)
    if states:
        print(f"  model: {states} states explored, "
              f"{sum(r.stats.get('transitions', 0) for r in reports)} "
              f"transitions")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"passes": sel, "quick": args.quick,
                       "wall_s": round(wall, 3),
                       "ok": not findings,
                       "reports": [r.to_dict() for r in reports]},
                      fh, indent=2)
        print(f"  report written to {args.json}")
    if findings:
        print(f"FAILED: {len(findings)} finding(s) in {wall:.1f}s")
        print(fail_fast(reports, limit=25))
        return 1
    print(f"OK: {len(reports)} reports, 0 findings in {wall:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
