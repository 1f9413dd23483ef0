"""graftlint CLI: ``python -m downloader_tpu_torch.analysis [paths...]``.

Exit status 0 = clean (suppressed findings don't count), 1 = findings,
2 = usage error.  ``--json`` emits one machine-readable document (the
``make lint`` mode); text mode prints one ``path:line: [rule] message``
per finding plus a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import DEFAULT_TARGETS, all_rules, analyze


def _repo_root() -> str:
    # downloader_tpu_torch/analysis/__main__.py -> repo root two levels up
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m downloader_tpu_torch.analysis",
        description="graftlint: repo-invariant static analysis "
                    "(docs/ANALYSIS.md)")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to analyze, relative to the "
                             f"repo root (default: {' '.join(DEFAULT_TARGETS)})")
    parser.add_argument("--root", default=None,
                        help="repo root (default: autodetected)")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON document instead of text")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids to run "
                             "(default: all)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    def emit(text: str) -> bool:
        """print() that tolerates a closed consumer (``... | head``):
        stops emitting but NEVER changes the exit status — a truncated
        listing of findings must still exit 1."""
        try:
            print(text)
            return True
        except BrokenPipeError:
            os.dup2(os.open(os.devnull, os.O_WRONLY),
                    sys.stdout.fileno())
            return False

    if args.list_rules:
        for rule in all_rules():
            if not emit(f"{rule.id} ({rule.scope})\n    {rule.doc}"):
                break
        return 0

    root = args.root or _repo_root()
    targets = tuple(args.paths) or DEFAULT_TARGETS
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    try:
        result = analyze(root, targets=targets, rules=rules)
    except ValueError as err:
        print(f"graftlint: {err}", file=sys.stderr)
        return 2
    if result.files == 0:
        # a typo'd path must not read as a clean tree
        print(f"graftlint: no Python files under {' '.join(targets)} "
              f"(root {root})", file=sys.stderr)
        return 2

    if args.json:
        emit(json.dumps(result.as_dict(), indent=2, sort_keys=True))
    else:
        for finding in result.findings:
            if not emit(finding.render()):
                break
        emit(f"graftlint: {len(result.findings)} finding(s), "
             f"{result.suppressed} suppressed, {result.files} files, "
             f"{result.duration_s:.2f}s")
    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
