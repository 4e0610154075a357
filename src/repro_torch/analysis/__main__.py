"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exit codes: 0 clean (every finding baselined with a real
justification), 1 new findings or TODO-justified baseline entries,
2 usage/parse error.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.engine import Baseline, analyze, write_baseline

DEFAULT_PATHS = ["src/repro_torch"]
DEFAULT_BASELINE = "analysis-baseline-torch.json"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="PyTorch-hazard lint pass for the repro_torch port")
    p.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                   help="files or directories to scan "
                        "(default: src/repro_torch)")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="report format (default: text)")
    p.add_argument("--baseline", default=DEFAULT_BASELINE,
                   help="baseline file of suppressed findings "
                        f"(default: {DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline file entirely")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite the baseline to suppress every current "
                        "finding (existing justifications are kept; new "
                        "entries get a TODO that the run rejects until a "
                        "real justification is written)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        from repro_torch.analysis.rules import ALL_RULES
        for r in ALL_RULES:
            print(f"{r.id}  {r.name}\n      {r.summary}")
        return 0

    baseline_path = None if args.no_baseline else args.baseline
    try:
        report = analyze(args.paths or DEFAULT_PATHS,
                         baseline_path=baseline_path)
    except (FileNotFoundError, SyntaxError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        previous = Baseline.load(baseline_path)
        write_baseline(args.baseline, report.findings, previous)
        todo = sum(1 for f in report.new
                   if Baseline.load(args.baseline).match(f))
        print(f"wrote {args.baseline}: {len(report.findings)} "
              f"suppression(s) ({todo} need a justification)")
        return 0

    if args.format == "json":
        print(json.dumps(report.to_json(), indent=2))
    else:
        print(report.to_text())
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
