"""CLI for the port's invariant checker: ``python -m repro_torch.analysis``.

Exit codes: 0 = clean (no unsuppressed findings, no stale suppressions),
1 = findings (or stale baseline entries), 2 = usage/config error.

Typical invocations::

    PYTHONPATH=src python -m repro_torch.analysis                 # text report
    PYTHONPATH=src python -m repro_torch.analysis --format json --out r.json
    PYTHONPATH=src python -m repro_torch.analysis --rules R1,R2   # subset
    PYTHONPATH=src python -m repro_torch.analysis --changed-only  # pre-commit
    PYTHONPATH=src python -m repro_torch.analysis --rules R8 --events runs/obs

``python -m repro_torch.analysis.protocol`` drives R7 and R8's pieces
(extract, the bounded model check, a log replay) alone.

``--changed-only [REF]`` keeps only findings in files changed vs REF
(default HEAD: staged + unstaged + untracked) — the pre-commit fast
path.  Rules still see the whole tree (cross-file invariants need it);
only the *reporting* is filtered, and stale-suppression errors are not
reported since unchanged files are out of scope.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional, Set

from . import (
    DEFAULT_BASELINE_PATH,
    RULES,
    apply_baseline,
    load_baseline,
    run_analysis,
)


def _find_root(start: Path) -> Path:
    """The repo root: the nearest ancestor holding ``src/repro_torch``."""
    cur = start.resolve()
    for cand in (cur, *cur.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    raise SystemExit(
        f"error: no src/repro_torch tree found at or above {start} "
        f"(pass --root explicitly)"
    )


def _changed_files(root: Path, ref: str) -> Optional[Set[str]]:
    """Repo-relative paths changed vs ``ref`` plus untracked files, or
    None if git is unavailable / ``root`` is not a work tree."""
    changed: Set[str] = set()
    for cmd in (
        ["git", "diff", "--name-only", ref, "--"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            out = subprocess.run(
                cmd, cwd=root, capture_output=True, text=True, check=True
            ).stdout
        except (OSError, subprocess.CalledProcessError):
            return None
        changed.update(line.strip() for line in out.splitlines()
                       if line.strip())
    return changed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=(
            "AST-based invariant checker over the port's trees: "
            "concurrency (R1, R2), frozen reference (R3), wire contract "
            "(R4), determinism (R5), event schema (R6), protocol model "
            "(R7), trace conformance (R8)."
        ),
    )
    parser.add_argument(
        "--root",
        type=Path,
        default=None,
        help="repo root (default: nearest ancestor of CWD with src/repro_torch)",
    )
    parser.add_argument(
        "--rules",
        default=None,
        help=f"comma-separated subset of {','.join(RULES)} (default: all)",
    )
    parser.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="report format (default: text)",
    )
    parser.add_argument(
        "--out",
        type=Path,
        default=None,
        help="also write the report to this file (same format)",
    )
    parser.add_argument(
        "--baseline",
        type=Path,
        default=None,
        help=f"suppression file (default: <root>/{DEFAULT_BASELINE_PATH})",
    )
    parser.add_argument(
        "--events",
        type=Path,
        action="append",
        default=None,
        metavar="PATH",
        help="events.jsonl file or directory for R8 trace conformance "
             "(repeatable; without it R8 is a no-op)",
    )
    parser.add_argument(
        "--changed-only",
        nargs="?",
        const="HEAD",
        default=None,
        metavar="REF",
        help="report only findings in files changed vs REF (default "
             "HEAD) plus untracked files — the pre-commit fast path",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalogue and exit",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule_id, (_, desc) in RULES.items():
            print(f"{rule_id}  {desc}")
        return 0

    root = args.root.resolve() if args.root else _find_root(Path.cwd())
    if not (root / "src" / "repro_torch").is_dir():
        print(f"error: {root} has no src/repro_torch tree", file=sys.stderr)
        return 2
    rules = args.rules.split(",") if args.rules else None
    try:
        findings = run_analysis(root, rules=rules, events=args.events)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    baseline_path = args.baseline or (root / DEFAULT_BASELINE_PATH)
    suppressions = load_baseline(baseline_path)
    active, suppressed, stale = apply_baseline(findings, suppressions)

    if args.changed_only is not None:
        changed = _changed_files(root, args.changed_only)
        if changed is None:
            print(
                f"error: --changed-only needs a git work tree at {root} "
                f"and a resolvable ref {args.changed_only!r}",
                file=sys.stderr,
            )
            return 2
        active = [f for f in active if f.path in changed]
        # unchanged files are out of scope, so a suppression pointing at
        # one is not actionable here — full runs still report staleness
        stale = []

    counts: dict = {}
    for f in active:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    # the report is machine-diffable across checkouts: every path in it,
    # including the root itself, is repo-relative
    report = {
        "version": 1,
        "root": ".",
        "rules": {rule_id: desc for rule_id, (_, desc) in RULES.items()},
        "findings": [f.to_json() for f in active],
        "suppressed": len(suppressed),
        "stale_suppressions": stale,
        "counts": counts,
        "ok": not active and not stale,
    }

    if args.format == "json":
        text = json.dumps(report, indent=2)
    else:
        lines = []
        for f in active:
            lines.append(f"{f.path}:{f.line}: [{f.rule}] "
                         f"{f.symbol + ': ' if f.symbol else ''}{f.message}")
        for entry in stale:
            lines.append(
                f"{baseline_path.name}: stale suppression {entry} — the "
                f"finding no longer exists; delete the entry"
            )
        if not lines:
            lines.append(
                f"analysis clean: {len(findings)} finding(s) total, "
                f"{len(suppressed)} suppressed, rules {','.join(RULES)}"
            )
        else:
            lines.append(
                f"{len(active)} finding(s) ({len(suppressed)} suppressed, "
                f"{len(stale)} stale suppression(s))"
            )
        text = "\n".join(lines)

    print(text)
    if args.out is not None:
        args.out.write_text(
            text + ("\n" if not text.endswith("\n") else ""), encoding="utf-8"
        )
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
