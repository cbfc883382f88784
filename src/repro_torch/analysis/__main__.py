"""CLI for the port's tracecheck: ``python -m repro_torch.analysis`` /
``repro-torch-tracecheck``.

Exit status is the CI contract: 0 when every finding is suppressed or
baselined, 1 when new findings exist, 2 on usage errors.  ``--github``
additionally emits GitHub-annotation lines and ``--summary`` writes a
markdown table (pointed at ``$GITHUB_STEP_SUMMARY`` by the lint job).
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.core import (RULES, load_modules,
                                       run_tracecheck, write_baseline)

#: the committed baseline's file name, at the root
BASELINE_NAME = "tracecheck_torch_baseline.json"


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro-torch-tracecheck",
        description="capture-safety / sharding-contract static analyzer "
                    "for the PyTorch port (stdlib-only, no torch needed)")
    p.add_argument("paths", nargs="*", default=None,
                   help="files/directories to scan (default: src/repro_torch)")
    p.add_argument("--root", default=None,
                   help="repo root used for relative finding paths "
                        "(default: cwd)")
    p.add_argument("--baseline", default=None,
                   help="baseline JSON of grandfathered findings (default: "
                        "<root>/tracecheck_torch_baseline.json if it "
                        "exists)")
    p.add_argument("--write-baseline", action="store_true",
                   help="write all current non-suppressed findings to the "
                        "baseline file and exit 0")
    p.add_argument("--rules", default=None,
                   help="comma list restricting which rule ids run")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    p.add_argument("--show-baselined", action="store_true",
                   help="also print findings matched by the baseline")
    p.add_argument("--github", action="store_true",
                   help="emit ::error annotations for new findings")
    p.add_argument("--summary", default=None,
                   help="write a markdown summary to this file "
                        "(use $GITHUB_STEP_SUMMARY in CI)")
    return p


def _markdown_summary(new, baselined, suppressed) -> str:
    lines = ["## tracecheck", ""]
    lines.append("| new | baselined | suppressed |")
    lines.append("|---|---|---|")
    lines.append(f"| {len(new)} | {len(baselined)} | {len(suppressed)} |")
    if new:
        lines += ["", "### New findings", "",
                  "| location | rule | message |", "|---|---|---|"]
        for f in new:
            lines.append(f"| `{f.path}:{f.line}` | {f.rule} "
                         f"| {f.message} |")
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.list_rules:
        for rid in sorted(RULES):
            print(f"{rid}  {RULES[rid]}")
        return 0

    root = os.path.abspath(args.root or os.getcwd())
    paths = args.paths or [os.path.join(root, "src", "repro_torch")]
    for p in paths:
        if not os.path.exists(p):
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    baseline = args.baseline
    if baseline is None:
        cand = os.path.join(root, BASELINE_NAME)
        baseline = cand if os.path.exists(cand) else None

    rules = [r.strip() for r in args.rules.split(",")] if args.rules else None
    new, baselined, suppressed = run_tracecheck(
        paths, root=root, baseline=None if args.write_baseline else baseline,
        rules=rules)

    if args.write_baseline:
        target = args.baseline or os.path.join(root, BASELINE_NAME)
        write_baseline(target, new)
        print(f"wrote {len(new)} finding(s) to {target}")
        return 0

    n_files = len(load_modules(paths, root=root))
    for f in new:
        print(f.format())
        if args.github:
            print(f"::error file={f.path},line={f.line},"
                  f"title=tracecheck {f.rule}::{f.message}")
    if args.show_baselined:
        for f in baselined:
            print(f"{f.format()}  [baselined]")
    print(f"tracecheck: {n_files} file(s), {len(new)} new, "
          f"{len(baselined)} baselined, {len(suppressed)} suppressed")
    if args.summary:
        with open(args.summary, "a", encoding="utf-8") as fh:
            fh.write(_markdown_summary(new, baselined, suppressed))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
