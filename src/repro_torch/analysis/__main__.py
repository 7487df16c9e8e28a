"""CLI: `python -m repro_torch.analysis [--strict] [--root DIR] [--report FILE]`.

Exit status:
  0  no unwaived violations (and, under --strict, every waiver has a reason)
  1  unwaived violations found, or --strict and a reason-less waiver
  2  bad invocation

The machine-readable report (default `analysis_report.json`, uploaded as a CI
artifact) lists every violation including waived ones, so waiver counts are
visible in review even though they do not fail the gate.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

from repro_torch.analysis import PASSES, package_root, run_all
from repro_torch.analysis import rules


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant checks for the port's serving engine and CUDA kernels.")
    ap.add_argument("--strict", action="store_true",
                    help="fail on any unwaived violation or reason-less "
                         "waiver (the CI gate mode)")
    ap.add_argument("--root", type=Path, default=None,
                    help="package root to scan (default: the installed "
                         "repro_torch package)")
    ap.add_argument("--report", type=Path,
                    default=Path("analysis_report.json"),
                    help="machine-readable report path ('-' to skip)")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=sorted(PASSES),
                    help="run only this pass (repeatable; default: all)")
    args = ap.parse_args(argv)

    root = (args.root or package_root()).resolve()
    if not root.is_dir():
        print(f"error: root {root} is not a directory", file=sys.stderr)
        return 2

    violations = run_all(root, args.passes)
    active = [v for v in violations if not v.waived]
    waived = [v for v in violations if v.waived]
    reasonless = [v for v in waived if not v.waive_reason]

    for v in violations:
        print(v.render())

    by_code = Counter(v.code for v in active)
    summary = (f"{len(active)} violation(s), {len(waived)} waived "
               f"({len(reasonless)} without a reason) across "
               f"{len(args.passes or PASSES)} pass(es)")
    print(summary)
    for code, n in sorted(by_code.items()):
        print(f"  {code} x{n}: {rules.RULES.get(code, '?')}")

    if str(args.report) != "-":
        report = {
            "root": str(root),
            "strict": bool(args.strict),
            "passes": sorted(args.passes or PASSES),
            "violations": [v.to_json() for v in violations],
            "counts": {"active": len(active), "waived": len(waived),
                       "waived_without_reason": len(reasonless),
                       "by_code": dict(by_code)},
            "ok": not active and not (args.strict and reasonless),
        }
        args.report.write_text(json.dumps(report, indent=2) + "\n")

    if active:
        return 1
    if args.strict and reasonless:
        print("strict: waivers without reason= are not allowed",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
