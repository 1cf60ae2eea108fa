"""CLI: ``python -m hbbft_tpu_torch.lint``.

Exit status: 0 = clean (baselined findings do not fail the run),
1 = actionable findings, 2 = usage/internal error.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from hbbft_tpu_torch.lint.core import (
    DEFAULT_BASELINE,
    DEFAULT_PATHS,
    render_baseline,
    rule_table,
    run_lint,
)
from hbbft_tpu_torch.lint.reporters import render_json, render_text


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hbbft_tpu_torch.lint",
        description="hblint: determinism / asyncio-hazard / "
                    "wire-completeness / fault-accounting / "
                    "metric-convention static analysis",
    )
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to scan, relative to the repo root "
                         f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detected from the "
                         "package location)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON instead of text")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file of grandfathered findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report everything)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write all current findings to the baseline "
                         "file and exit 0 (then edit the justifications)")
    ap.add_argument("--changed-only", metavar="GITREF", default=None,
                    help="per-file checks only on files changed vs this "
                         "git ref (project-wide checks always run)")
    ap.add_argument("--show-baselined", action="store_true",
                    help="also list baselined findings in text output")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, (checker, desc) in sorted(rule_table().items()):
            print(f"{rule:28s} [{checker}] {desc}")
        return 0

    if args.write_baseline and (args.paths or args.changed_only):
        # a restricted scan sees only a subset of findings; writing it
        # wholesale would silently delete every other grandfathered entry
        print("hblint: error: --write-baseline requires a full scan "
              "(no path arguments, no --changed-only)", file=sys.stderr)
        return 2

    baseline = None if args.no_baseline else args.baseline
    try:
        result = run_lint(
            root=args.root,
            paths=args.paths or None,
            baseline_path=None if args.write_baseline else baseline,
            changed_only=args.changed_only,
        )
    except RuntimeError as exc:
        print(f"hblint: error: {exc}", file=sys.stderr)
        return 2

    if args.write_baseline:
        with open(args.baseline, "w", encoding="utf-8") as fh:
            fh.write(render_baseline(result.findings))
        print(f"hblint: wrote {len(result.findings)} entries to "
              f"{args.baseline} — now edit the justifications")
        return 0

    if args.json:
        print(render_json(result))
    else:
        print(render_text(result, verbose_baseline=args.show_baselined))
    return 0 if result.clean else 1


if __name__ == "__main__":
    sys.exit(main())
