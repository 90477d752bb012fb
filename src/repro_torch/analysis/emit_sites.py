"""Where the runtime emits observability events, read from the AST.

A ``.emit(...)`` call on a bus-shaped receiver (a name containing ``bus``,
or an attribute access ending in ``.bus`` such as ``self.master.bus``) is
an event emit site; its first argument, a string literal, is the event
type, registered with its fields in ``EVENT_MANIFEST_PATH``.  The protocol
extractor reads the transitions' events from these sites.
"""

from __future__ import annotations

import ast
from typing import List, Tuple

__all__ = ["EVENT_MANIFEST_PATH", "emit_sites"]

#: Repo-relative path of the port's pinned event-schema manifest.
EVENT_MANIFEST_PATH = "src/repro_torch/obs/event_manifest.json"


def _is_bus_receiver(node: ast.expr) -> bool:
    """True for receivers that are observably the event bus: a bare name
    containing ``bus`` or an attribute whose name contains it."""
    if isinstance(node, ast.Name):
        return "bus" in node.id
    if isinstance(node, ast.Attribute):
        return "bus" in node.attr
    return False


def emit_sites(tree: ast.AST) -> List[Tuple[ast.Call, ast.expr]]:
    """(call, receiver) of every ``bus.emit`` call under ``tree``."""
    out: List[Tuple[ast.Call, ast.expr]] = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "emit"
            and _is_bus_receiver(node.func.value)
        ):
            out.append((node, node.func.value))
    return out
