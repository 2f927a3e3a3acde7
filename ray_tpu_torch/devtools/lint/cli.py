"""raylint command line: ``python -m ray_tpu_torch.devtools.lint [paths]``.

Exit code 0 when no finding clears the ``--fail-on`` threshold (all
suppressed, or warn-only findings under ``--fail-on error``), 1 when
failing findings remain, 2 on usage errors.

Results are cached under ``.raylint_cache/`` keyed by (file content
sha, ruleset fingerprint); a warm run over an unchanged tree skips
parsing and per-file analysis entirely. ``--no-cache`` disables it,
``--cache-dir`` relocates it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ray_tpu_torch.devtools.lint.engine import DEFAULT_CACHE_DIR, run_lint
from ray_tpu_torch.devtools.lint.registry import all_rules


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.lint",
        description="raylint: distributed-correctness static analysis "
                    "for ray_tpu_torch")
    parser.add_argument("paths", nargs="*", default=["ray_tpu_torch"],
                        help="files or directories to lint "
                             "(default: ray_tpu_torch)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit the machine-readable report (stable "
                             "schema, version 3) instead of text")
    parser.add_argument("--changed-only", action="store_true",
                        help="limit to files changed vs git HEAD plus "
                             "untracked files (fast pre-commit mode); "
                             "falls back to a full scan without git")
    parser.add_argument("--rule", action="append", default=None,
                        metavar="RULE-ID",
                        help="run only this rule (repeatable)")
    parser.add_argument("--fail-on", choices=("error", "warn"),
                        default="warn",
                        help="minimum severity that fails the run "
                             "(default: warn — any unsuppressed finding)")
    parser.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR,
                        metavar="DIR",
                        help="result cache location "
                             f"(default: {DEFAULT_CACHE_DIR})")
    parser.add_argument("--no-cache", action="store_true",
                        help="analyze every file from scratch")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="also print suppressed findings in text mode")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    rules = all_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id:24s} [{r.severity}] {r.doc}")
        return 0
    if args.rule:
        known = {r.id for r in rules}
        bad = [r for r in args.rule if r not in known]
        if bad:
            print(f"unknown rule(s): {', '.join(bad)}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.id in set(args.rule)]

    report = run_lint(args.paths, rules=rules,
                      changed_only=args.changed_only,
                      cache_dir=None if args.no_cache else args.cache_dir)

    if args.as_json:
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
        # bench.py-style greppable one-liner; stderr keeps stdout pure JSON
        print(report.summary_line(), file=sys.stderr)
    else:
        for f in report.findings:
            if f.suppressed and not args.show_suppressed:
                continue
            print(f.render())
        print(report.summary_line())
    return 1 if report.failing(args.fail_on) else 0


if __name__ == "__main__":
    sys.exit(main())
