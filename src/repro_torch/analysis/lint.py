"""Contract-lint CLI for the port (Python and CUDA sources).

    PYTHONPATH=src python -m repro_torch.analysis.lint            # report
    PYTHONPATH=src python -m repro_torch.analysis.lint --check    # CI gate
    PYTHONPATH=src python -m repro_torch.analysis.lint --update-baseline
    PYTHONPATH=src python -m repro_torch.analysis.lint --list-rules

Exit status: 0 when findings match the committed baseline exactly
(empty baseline + clean tree included); 1 on any non-baselined finding
OR any stale baseline entry (a fixed violation whose baseline shrink
was not committed); 2 on usage errors.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import baseline as bl
from repro_torch.analysis import report
from repro_torch.analysis.config import default_config
from repro_torch.analysis.core import RULES, _ensure_rules_loaded
from repro_torch.analysis.driver import run_lint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="contract lint of the port: determinism, masking, "
                    "counter symmetry and the CUDA kernels' contracts")
    ap.add_argument("paths", nargs="*",
                    help="root-relative files/dirs to scan "
                         "(default: src/repro_torch)")
    ap.add_argument("--root", default=None,
                    help="checkout root (default: derived from the "
                         "package location)")
    ap.add_argument("--check", action="store_true",
                    help="gate mode: quiet on success, exit 1 on any "
                         "baseline drift")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to the current findings")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: LINT_BASELINE_TORCH.json "
                         "at the root)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        _ensure_rules_loaded()
        print(report.rule_catalog(RULES))
        return 0

    overrides = {}
    if args.paths:
        overrides["paths"] = tuple(args.paths)
    if args.baseline:
        overrides["baseline_path"] = args.baseline
    try:
        config = default_config(root=args.root, **overrides)
        result = run_lint(config)
    except (OSError, SyntaxError, ValueError) as e:
        print(f"lint: error: {e}", file=sys.stderr)
        return 2

    if args.update_baseline:
        bl.save_baseline(config.abs_baseline(), result.active)
        print(f"lint: baseline written to {config.abs_baseline()} "
              f"({len(result.active)} finding(s))")
        return 0

    if args.as_json:
        print(report.to_json(result.active, result.suppressed,
                             result.new, result.stale,
                             len(result.modules)))
        return 0 if result.ok else 1

    if result.new:
        print(report.format_findings(result.new))
    baselined = len(result.active) - len(result.new)
    if not args.check or not result.ok:
        print(report.summary_line(result.active, result.suppressed,
                                  len(result.modules)))
        if baselined:
            print(f"lint: {baselined} finding(s) tolerated by the "
                  f"baseline")
    for fp in result.stale:
        print(f"lint: stale baseline entry (violation fixed but shrink "
              f"not committed — run --update-baseline): {fp}")
    if result.ok and args.check:
        print(f"lint: clean ({len(result.modules)} files, "
              f"{len(result.suppressed)} pragma-suppressed)")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
