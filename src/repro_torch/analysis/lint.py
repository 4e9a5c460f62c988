"""Command line of the port's linter (port of ``repro.analysis.lint``)::

    python -m repro_torch.analysis.lint src/repro_torch/ [--format json]

Exit codes: 0 — clean (possibly with reasoned suppressions); 1 — at least
one active (unsuppressed) finding; 2 — usage / IO error.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Iterator, List, Tuple

from repro_torch.analysis.engine import (default_rules, render_json, render_text,
                                   run_lint)

_SKIP_DIRS = {".git", "__pycache__", ".venv", "node_modules", "build",
              "dist", ".mypy_cache", ".ruff_cache"}


def iter_py_files(paths: List[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        else:
            raise FileNotFoundError(p)


def load_sources(paths: List[str]) -> List[Tuple[str, str]]:
    out = []
    for path in iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            out.append((path, fh.read()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="contract linter for the PyTorch port of the repro serving stack")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="include suppressed findings in text output")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    rules = default_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id}  {r.title}\n      contract: {r.contract}")
        return 0
    if args.rules:
        wanted = {r.strip().upper() for r in args.rules.split(",")}
        unknown = wanted - {r.id for r in rules}
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = [r for r in rules if r.id in wanted]

    try:
        sources = load_sources(args.paths)
    except FileNotFoundError as e:
        print(f"no such file or directory: {e}", file=sys.stderr)
        return 2
    if not sources:
        print("no python files found", file=sys.stderr)
        return 2

    findings, _ = run_lint(sources, rules=rules)
    if args.format == "json":
        print(render_json(findings, rules=rules))
    else:
        print(render_text(findings, show_suppressed=args.show_suppressed))
    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
