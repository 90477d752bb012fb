"""CLI for the protocol model checker.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.protocol extract [--write|--diff]
    PYTHONPATH=src python -m repro_torch.analysis.protocol check [--mutate EVENT]
    PYTHONPATH=src python -m repro_torch.analysis.protocol conformance LOG [LOG...]

``extract`` rebuilds the machines from the tree (``--write`` updates the
committed manifest, ``--diff`` exits 1 on drift and can dump a drift
report with ``--out``); ``check`` exhaustively explores the bounded
configuration and prints the counterexample trace on a violation
(``--mutate msg.requeued`` demonstrates one); ``conformance`` replays
event logs.  Exit codes: 0 clean, 1 findings/violations, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from ..model import RepoIndex
from .conformance import load_events_file, replay_events
from .explore import BoundedConfig, drop_transition, explore, render_trace
from .extract import extract_protocol
from .machines import PROTOCOL_MANIFEST_PATH, diff_manifests
from .rules import iter_event_logs


def _find_root(start: Path) -> Path:
    cur = start.resolve()
    for cand in (cur, *cur.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    raise SystemExit(
        f"error: no src/repro_torch tree found at or above {start} "
        f"(pass --root explicitly)"
    )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.protocol",
        description="extract, model-check, and replay the delivery protocol",
    )
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: nearest ancestor with "
                         "src/repro_torch)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("extract", help="rebuild machines from the tree")
    p.add_argument("--write", action="store_true",
                   help=f"update {PROTOCOL_MANIFEST_PATH}")
    p.add_argument("--diff", action="store_true",
                   help="diff against the committed manifest (exit 1 on "
                        "drift)")
    p.add_argument("--out", type=Path, default=None,
                   help="write the drift/extraction report (JSON) here")

    p = sub.add_parser("check", help="exhaustive bounded model check")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--pes", type=int, default=1,
                   help="PEs per worker (default 1 → 2 PEs total)")
    p.add_argument("--messages", type=int, default=3)
    p.add_argument("--kills", type=int, default=1)
    p.add_argument("--mutate", default=None, metavar="EVENT",
                   help="drop this transition first (seeded-mutation "
                        "demo, e.g. msg.requeued)")
    p.add_argument("--unsafe-harvest", action="store_true",
                   help="model a kill that harvests the pre-drain mirror "
                        "(the harvest/completion race)")

    p = sub.add_parser("conformance", help="replay event logs")
    p.add_argument("events", nargs="+", type=Path,
                   help="events.jsonl files or directories holding them")

    args = ap.parse_args(argv)
    root = args.root.resolve() if args.root else _find_root(Path.cwd())
    manifest_file = root / PROTOCOL_MANIFEST_PATH

    if args.cmd == "extract":
        index = RepoIndex(root)
        manifest, findings = extract_protocol(index, root)
        findings = index.parse_findings + findings
        for f in findings:
            print(f"{f.path}:{f.line}: [{f.rule}] {f.message}",
                  file=sys.stderr)
        if args.write:
            manifest_file.parent.mkdir(parents=True, exist_ok=True)
            manifest_file.write_text(
                json.dumps(manifest, indent=2, sort_keys=False) + "\n",
                encoding="utf-8",
            )
            print(f"wrote {PROTOCOL_MANIFEST_PATH}")
            return 1 if findings else 0
        if args.diff:
            if not manifest_file.is_file():
                drift = ["committed manifest is missing"]
            else:
                drift = diff_manifests(
                    manifest,
                    json.loads(manifest_file.read_text(encoding="utf-8")),
                )
            report = {
                "drift": drift,
                "extraction_findings": [f.to_json() for f in findings],
                "ok": not drift and not findings,
            }
            if args.out is not None:
                args.out.write_text(json.dumps(report, indent=2) + "\n",
                                    encoding="utf-8")
            for line in drift:
                print(f"drift: {line}")
            print("clean: code and committed manifest agree" if report["ok"]
                  else f"{len(drift)} drift line(s), "
                       f"{len(findings)} extraction finding(s)")
            return 0 if report["ok"] else 1
        print(json.dumps(manifest, indent=2))
        return 1 if findings else 0

    if args.cmd == "check":
        if not manifest_file.is_file():
            print(f"error: {PROTOCOL_MANIFEST_PATH} missing — run "
                  f"extract --write first", file=sys.stderr)
            return 2
        manifest = json.loads(manifest_file.read_text(encoding="utf-8"))
        if args.mutate:
            manifest = drop_transition(manifest, args.mutate)
            print(f"mutated model: dropped every {args.mutate!r} edge")
        cfg = BoundedConfig(workers=args.workers, pes_per_worker=args.pes,
                            messages=args.messages, kills=args.kills)
        result = explore(manifest, cfg,
                         unsafe_harvest=args.unsafe_harvest)
        print(f"explored {result.states} states / "
              f"{result.transitions} transitions "
              f"({cfg.workers} workers x {cfg.pes_per_worker} PE x "
              f"{cfg.messages} messages, {cfg.kills} kill(s))")
        for v in result.violations:
            print(render_trace(v))
        if result.ok:
            print("all delivery invariants hold on every interleaving")
        return 0 if result.ok else 1

    if args.cmd == "conformance":
        if not manifest_file.is_file():
            print(f"error: {PROTOCOL_MANIFEST_PATH} missing", file=sys.stderr)
            return 2
        manifest = json.loads(manifest_file.read_text(encoding="utf-8"))
        logs = iter_event_logs(args.events)
        if not logs:
            print("error: no events.jsonl logs found", file=sys.stderr)
            return 2
        bad = 0
        for log in logs:
            events, errors = load_events_file(log)
            summary = replay_events(events, manifest)
            for err in errors:
                print(f"{log}: {err}", file=sys.stderr)
                bad += 1
            for v in summary.violations:
                print(f"{log}: {v}", file=sys.stderr)
                bad += 1
            print(f"{log}: {summary.events} events, "
                  f"{summary.completed} completed, "
                  f"{summary.requeued} requeued, "
                  f"{summary.backlog} left queued, "
                  f"{len(summary.violations)} violation(s)")
        return 1 if bad else 0

    return 2  # pragma: no cover


if __name__ == "__main__":
    sys.exit(main())
