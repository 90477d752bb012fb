"""Baseline / suppression file for the invariant checker.

The committed baseline (``src/repro_torch/analysis/baseline.json``, the
port's own: the repo root's ``analysis-baseline.json`` is
``python -m repro.analysis``'s) lists findings that are acknowledged and
deliberately not fixed yet.  It ships **empty**: a finding in the port is
a fault of the port, and the tier-1 gate fails on any unsuppressed
finding, so new violations cannot land without either a fix or an
explicit, reviewable suppression entry.

A suppression matches on ``(rule, path, symbol, message)`` — not the
line number — so edits elsewhere in a file cannot silently detach it,
while any change to the finding itself (different message, moved
function) makes the suppression stale.  Stale suppressions are reported
so the baseline can only shrink back to empty, never rot.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

from .model import Finding

__all__ = ["load_baseline", "apply_baseline", "DEFAULT_BASELINE_PATH"]

#: Root-relative path of the port's committed baseline.
DEFAULT_BASELINE_PATH = "src/repro_torch/analysis/baseline.json"


def load_baseline(path: Path) -> List[Dict[str, str]]:
    """Read the suppression list; a missing file is an empty baseline."""
    if not path.is_file():
        return []
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    suppressions = data.get("suppressions", [])
    if not isinstance(suppressions, list):
        raise ValueError(f"{path}: 'suppressions' must be a list")
    return suppressions


def _suppression_key(entry: Dict[str, str]) -> str:
    return (
        f"{entry.get('rule', '')}:{entry.get('path', '')}:"
        f"{entry.get('symbol', '')}:{entry.get('message', '')}"
    )


def apply_baseline(
    findings: List[Finding], suppressions: List[Dict[str, str]]
) -> Tuple[List[Finding], List[Finding], List[Dict[str, str]]]:
    """Split findings into (active, suppressed) and report stale entries."""
    keys = {_suppression_key(e): e for e in suppressions}
    active: List[Finding] = []
    suppressed: List[Finding] = []
    used = set()
    for f in findings:
        k = f.key()
        if k in keys:
            suppressed.append(f)
            used.add(k)
        else:
            active.append(f)
    stale = [e for k, e in keys.items() if k not in used]
    return active, suppressed, stale
