"""Observability analyzer CLI.

Usage (see ``--help`` per subcommand)::

    PYTHONPATH=src python -m repro_torch.obs latency RUN/events.jsonl
    PYTHONPATH=src python -m repro_torch.obs trace RUN/events.jsonl --msg 17
    PYTHONPATH=src python -m repro_torch.obs audit RUN/events.jsonl
    PYTHONPATH=src python -m repro_torch.obs diff SIM/events.jsonl LIVE/events.jsonl
    PYTHONPATH=src python -m repro_torch.obs schema-check RUN/events.jsonl
    PYTHONPATH=src python -m repro_torch.obs summary RUN/events.jsonl

Exit codes: 0 clean, 1 schema violations (``schema-check``) or missing
data, 2 usage errors.

The JAX package's CLI has one more subcommand, ``conformance``: it replays a
log against the protocol state machines that the repository's static
checker extracts from the source tree (``analysis/protocol``).  That checker
is a tool over the repository's sources, not a part of the system, and the
port has no copy of it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .analyze import (
    audit_report,
    critical_path,
    drift_report,
    e2e_percentiles,
    latency_decomposition,
    render_drift,
    summarize,
    validate_events,
)
from .exporters import load_events


def _add_log_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("events", help="path to an events.jsonl log")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="analyze observability event logs",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("latency",
                       help="decompose e2e latency per image class")
    _add_log_arg(p)
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")

    p = sub.add_parser("trace", help="one message's critical path")
    _add_log_arg(p)
    p.add_argument("--msg", type=int, required=True, help="message id")

    p = sub.add_parser("audit", help="render the IRM decision audit")
    _add_log_arg(p)
    p.add_argument("--run", type=int, default=None,
                   help="only this packing run (0-based)")

    p = sub.add_parser("diff",
                       help="drift report between two event logs")
    p.add_argument("events_a")
    p.add_argument("events_b")
    p.add_argument("--json", action="store_true")

    p = sub.add_parser("schema-check",
                       help="validate a log against event_manifest.json "
                            "(exit 1 on violations)")
    _add_log_arg(p)

    p = sub.add_parser("summary", help="event counts and e2e percentiles")
    _add_log_arg(p)

    args = ap.parse_args(argv)

    if args.cmd == "diff":
        rep = drift_report(load_events(args.events_a),
                           load_events(args.events_b))
        if args.json:
            print(json.dumps(rep, indent=2))
        else:
            print(render_drift(rep))
        return 0

    events = load_events(args.events)

    if args.cmd == "latency":
        dec = latency_decomposition(events)
        pct = e2e_percentiles(events)
        if args.json:
            print(json.dumps({"by_image": dec["by_image"],
                              "totals": dec["totals"], "e2e": pct},
                             indent=2))
            return 0
        t = dec["totals"]
        print(f"{t['count']} completed messages")
        print(f"mean components: queue_wait={t['queue_wait']:.3f}s "
              f"handoff={t['handoff']:.3f}s service={t['service']:.3f}s "
              f"e2e={t['e2e']:.3f}s")
        print("per image class (mean seconds):")
        for image, agg in sorted(dec["by_image"].items()):
            print(f"  {image:<28} n={agg['count']:<5} "
                  f"queue_wait={agg['queue_wait']:.3f} "
                  f"handoff={agg['handoff']:.3f} "
                  f"service={agg['service']:.3f} e2e={agg['e2e']:.3f}")
        if pct["count"]:
            print(f"e2e latency from arrival: p50={pct['p50']:.2f}s "
                  f"p95={pct['p95']:.2f}s p99={pct['p99']:.2f}s")
        return 0

    if args.cmd == "trace":
        path = critical_path(events, args.msg)
        if not path:
            print(f"no events for msg_id {args.msg}", file=sys.stderr)
            return 1
        for hop in path:
            where = ""
            if hop["worker"] is not None:
                where = f"  worker={hop['worker']}"
                if hop["pe"] is not None:
                    where += f" pe={hop['pe']}"
            print(f"t={hop['t']:>9.3f}  (+{hop['dt']:.3f}s)  "
                  f"{hop['ev']}{where}")
        return 0

    if args.cmd == "audit":
        print(audit_report(events, run=args.run))
        return 0

    if args.cmd == "schema-check":
        violations = validate_events(events)
        if violations:
            for v in violations:
                print(f"schema violation: {v}", file=sys.stderr)
            return 1
        print(f"ok: {len(events)} events conform to the manifest")
        return 0

    if args.cmd == "summary":
        s = summarize(events)
        print(json.dumps(s, indent=2))
        return 0

    return 2  # pragma: no cover


if __name__ == "__main__":
    try:
        code = main()
    except BrokenPipeError:
        # downstream pipe (e.g. ``| head``) closed early: not an error
        sys.stderr.close()
        code = 0
    raise SystemExit(code)
