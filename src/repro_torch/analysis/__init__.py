"""``repro_torch.analysis`` — AST-based invariant checker for the port's
runtime: its concurrency, determinism, and wire contracts, and its
delivery protocol.

The rules are the JAX package's (``repro.analysis``), pointed at the
port's trees (``model.ANALYZED_TREES``: ``src/repro_torch/``, the port's
tests, examples and tools, and ``chip_smoke.py``).  ``python -m
repro.analysis`` parses the port's files but checks R1, R2, R4 and R5
only on the JAX package's paths, and R6 against the JAX manifest, so
this package is what guards the port's runtime:

=====  ====================================================================
Rule   Guarantee protected
=====  ====================================================================
R1     blocking-in-async: nothing reachable from the runtime's ``async
       def`` bodies may block the event loop (``@worker_side`` code and
       annotated ``@loop_only(blocking=…)`` sections excepted); a
       ``torch.cuda.synchronize()`` or any ``.synchronize()`` blocks
R2     affinity: the multiproc data channel is single-consumer
       (``@loop_only`` readers only) and master-side mirrors (the
       payload launch counts among them) / ``Master`` queues mutate only
       on the loop thread, never worker-side
R3     frozen reference: the reference simulator the port's sim is held
       to, ``src/repro/core/sim_reference.py``, is pinned by content hash
       and imported by no file of the port's trees
R4     wire contract: every class pickled across the port's transport
       has its field set registered in ``wire_manifest.json`` and
       round-tripped by ``tests/test_torch_wire_contract.py``
R5     determinism: no wall-clock reads, ambient RNG (numpy's, the
       stdlib's or torch's global generator), or set-order iteration in
       ``core/`` sim paths
R6     event schema: every ``bus.emit`` call site in ``src/repro_torch/``
       matches the pinned field set in ``obs/event_manifest.json``, no
       manifest entry is stale, and every entry is exercised by
       ``tests/test_torch_obs.py``
R7     protocol model: the master↔worker state machines extracted from
       the runtime's ASTs match ``protocol/protocol_manifest.json``, and
       the committed machines pass an exhaustive bounded model check
       (at-least-once delivery, no duplicate completion, kill-harvest
       safety) over every interleaving with SIGKILL injection
R8     trace conformance: recorded ``events.jsonl`` logs replay cleanly
       against the protocol machines (only runs when ``--events`` paths
       are given)
=====  ====================================================================

Run it with ``python -m repro_torch.analysis`` (see ``__main__.py``);
``python -m repro_torch.analysis.protocol`` drives R7 and R8's pieces
alone.  The checker is stdlib-only — it parses the tree, it never
imports it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

from .baseline import DEFAULT_BASELINE_PATH, apply_baseline, load_baseline
from .model import ANALYZED_TREES, Finding, RepoIndex
from .protocol.rules import check_protocol_model, check_trace_conformance
from .rules_concurrency import check_affinity, check_blocking_in_async
from .rules_contracts import check_frozen_reference, check_wire_contract
from .rules_determinism import check_determinism
from .rules_obs import check_event_schema

__all__ = [
    "RULES",
    "Finding",
    "RepoIndex",
    "run_analysis",
    "apply_baseline",
    "load_baseline",
    "DEFAULT_BASELINE_PATH",
    "ANALYZED_TREES",
]

#: rule id -> (checker, one-line description); order is report order.
RULES: Dict[str, tuple] = {
    "R1": (
        check_blocking_in_async,
        "no blocking calls reachable from runtime async code",
    ),
    "R2": (
        check_affinity,
        "single-consumer data channel + loop-thread-only mirror/queue mutation",
    ),
    "R3": (
        check_frozen_reference,
        "the reference sim's content-hash pin + no import of it in the port",
    ),
    "R4": (
        check_wire_contract,
        "transport-pickled field sets registered and contract-tested",
    ),
    "R5": (
        check_determinism,
        "no wall-clock, ambient RNG, or set-order iteration in core/",
    ),
    "R6": (
        check_event_schema,
        "bus-emitted event types pinned in the event-schema manifest + tested",
    ),
    "R7": (
        check_protocol_model,
        "protocol machines match the manifest and model-check clean",
    ),
    "R8": (
        check_trace_conformance,
        "recorded event logs replay cleanly against the protocol machines",
    ),
}


def run_analysis(
    root: Path,
    rules: Optional[Iterable[str]] = None,
    index: Optional[RepoIndex] = None,
    events: Optional[Iterable[Path]] = None,
) -> List[Finding]:
    """Run the selected rules (default: all) over the tree at ``root``.

    Returns findings sorted by (rule, path, line).  Parse failures in any
    analyzed file are reported under the pseudo-rule ``parse`` regardless
    of the selection — an unparseable file is never a clean file — and
    each once, though R7 and R8 report them too when run alone.

    ``events`` is R8's input: paths to ``events.jsonl`` files (or
    directories holding them) to replay against the protocol machines.
    With no paths, R8 is a clean no-op.
    """
    root = Path(root)
    if index is None:
        index = RepoIndex(root)
    selected = list(rules) if rules is not None else list(RULES)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rules {unknown}; available: {list(RULES)}")
    findings: List[Finding] = []
    event_paths = list(events) if events is not None else None
    for rule_id in selected:
        checker: Callable = RULES[rule_id][0]
        if rule_id == "R8":
            found = checker(index, root, event_paths)
        else:
            found = checker(index, root)
        findings.extend(f for f in found if f.rule != "parse")
    # after the rules: a file a rule parsed on request is in the list too
    findings.extend(index.parse_findings)
    return sorted(findings, key=lambda f: (f.rule, f.path, f.line, f.message))
