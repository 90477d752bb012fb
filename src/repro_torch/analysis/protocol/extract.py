"""Protocol extraction (rule R7's front half).

Walks the ASTs of the four runtime modules that carry the delivery
protocol — ``runtime/master.py``, ``runtime/worker.py``,
``runtime/lifecycle.py``, ``runtime/transport.py``, the port's by default
(``extract_protocol``'s keywords name another tree's) — and recovers the
per-entity state machines:

- **states** come from the lifecycle enums (``core.sim.PEState`` /
  ``WorkerState``, parsed not imported) plus the synthetic ``created``
  initial;
- **transitions** come from the ``@transition`` declarations the runtime
  carries next to the code (``runtime.annotations``).  Every declaration
  is verified against evidence in the same function: a ``bus.emit`` of
  the declared event, or a mirror assignment / enum reference of the
  declared destination state.  Conversely, every protocol ``bus.emit``
  site and every ``.state = Enum.MEMBER`` mirror assignment must be
  covered by a declaration — a transition the extractor cannot see is a
  finding, not a silent gap;
- **wire frames** come from every queue ``put``/``put_nowait`` whose
  payload literal starts with a ``_EV_*`` / ``_CMD_*`` tag and every
  dispatch comparison against one, giving each frame its producer and
  consumer sites; data-channel reads outside ``@loop_only`` code break
  the single-consumer invariant and are findings.

The assembled machines are serialized canonically and diffed against the
committed ``protocol_manifest.json`` — drift is a finding, exactly like
R4's wire contract.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..emit_sites import EVENT_MANIFEST_PATH, emit_sites
from ..model import Finding, FunctionInfo, ModuleIndex, RepoIndex
from .machines import (
    ENTITY_SPEC,
    PROTOCOL_MANIFEST_PATH,
    Machine,
    Transition,
    diff_manifests,
    machines_to_manifest,
)

__all__ = ["PROTOCOL_MODULES", "SIM_PATH", "extract_protocol", "extract_findings"]

#: The modules that carry the delivery protocol, in walk order.
PROTOCOL_MODULES = (
    "src/repro_torch/runtime/master.py",
    "src/repro_torch/runtime/worker.py",
    "src/repro_torch/runtime/lifecycle.py",
    "src/repro_torch/runtime/transport.py",
)

#: The module holding the lifecycle enums.
SIM_PATH = "src/repro_torch/core/sim.py"
_FRAME_PREFIXES = ("_EV_", "_CMD_")

_R7 = "R7"


def _finding(path: str, line: int, symbol: str, message: str) -> Finding:
    return Finding(rule=_R7, path=path, line=line, symbol=symbol,
                   message=message)


# ---------------------------------------------------------------------------
# state vocabulary: the lifecycle enums, parsed from core/sim.py
# ---------------------------------------------------------------------------

def _enum_states(index: RepoIndex, sim_path: str) -> Dict[str, Set[str]]:
    """{"PEState": {"starting", ...}, "WorkerState": {...}} from the
    enum class bodies (simple ``NAME = ...`` assignments, lowercased)."""
    out: Dict[str, Set[str]] = {}
    mod = index.module(sim_path)
    if mod is None:
        return out
    for cls_name, cls in mod.classes().items():
        if cls_name not in ("PEState", "WorkerState"):
            continue
        members: Set[str] = set()
        for node in cls.body:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and not tgt.id.startswith("_"):
                        members.add(tgt.id.lower())
        out[cls_name] = members
    return out


_ENUM_FOR_ENTITY = {"pe": "PEState", "worker": "WorkerState"}


# ---------------------------------------------------------------------------
# per-function facts
# ---------------------------------------------------------------------------

def _decl_transitions(fn: FunctionInfo) -> List[Tuple[dict, int]]:
    """The ``@transition(...)`` declarations on ``fn`` (with lines)."""
    out: List[Tuple[dict, int]] = []
    for dec in getattr(fn.node, "decorator_list", []):
        if not (isinstance(dec, ast.Call) and (
            (isinstance(dec.func, ast.Name) and dec.func.id == "transition")
            or (isinstance(dec.func, ast.Attribute)
                and dec.func.attr == "transition")
        )):
            continue
        decl: dict = {"entity": None, "event": None, "src": None,
                      "dst": None, "failing": False, "scope": None}
        pos = ("entity", "event", "src", "dst")
        ok = True
        for i, arg in enumerate(dec.args):
            if i >= len(pos) or not isinstance(arg, ast.Constant):
                ok = False
                break
            decl[pos[i]] = arg.value
        for kw in dec.keywords:
            if kw.arg in decl and isinstance(kw.value, ast.Constant):
                decl[kw.arg] = kw.value.value
            else:
                ok = False
        decl["_literal"] = ok
        out.append((decl, dec.lineno))
    return out


def _emit_events(node: ast.AST) -> List[Tuple[str, int]]:
    """(event type, line) of every literal ``bus.emit`` under ``node``."""
    out: List[Tuple[str, int]] = []
    for call, _recv in emit_sites(node):
        if call.args and isinstance(call.args[0], ast.Constant) and \
                isinstance(call.args[0].value, str):
            out.append((call.args[0].value, call.lineno))
    return out


def _enum_refs(node: ast.AST) -> Set[Tuple[str, str]]:
    """Every ``PEState.X`` / ``WorkerState.X`` reference under ``node``."""
    out: Set[Tuple[str, str]] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                and n.value.id in ("PEState", "WorkerState"):
            out.add((n.value.id, n.attr))
    return out


def _mirror_assignments(tree: ast.Module) -> List[Tuple[str, str, int]]:
    """Every ``<recv>.state = Enum.MEMBER`` mirror assignment in the
    module (receiver other than ``self`` — constructors set the *initial*
    state, which is not a transition).  Returns (enum, member, line)."""
    out: List[Tuple[str, str, int]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        val = node.value
        if not (isinstance(val, ast.Attribute)
                and isinstance(val.value, ast.Name)
                and val.value.id in ("PEState", "WorkerState")):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Attribute) and tgt.attr == "state" \
                    and not (isinstance(tgt.value, ast.Name)
                             and tgt.value.id == "self"):
                out.append((val.value.id, val.attr, node.lineno))
    return out


def _enclosing_functions(mod: ModuleIndex, line: int) -> List[FunctionInfo]:
    """Every function whose span contains ``line`` (outermost first)."""
    out = [
        fn for fn in mod.functions
        if fn.node.lineno <= line <= (fn.node.end_lineno or fn.node.lineno)
    ]
    out.sort(key=lambda fn: fn.node.lineno)
    return out


# ---------------------------------------------------------------------------
# wire frames
# ---------------------------------------------------------------------------

def _frame_names(node: ast.expr) -> List[str]:
    if isinstance(node, ast.Name) and node.id.startswith(_FRAME_PREFIXES):
        return [node.id]
    if isinstance(node, ast.Tuple):
        out: List[str] = []
        for elt in node.elts:
            out.extend(_frame_names(elt))
        return out
    return []


def _receiver_tail(node: ast.expr) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _site(mod: ModuleIndex, line: int) -> str:
    fns = _enclosing_functions(mod, line)
    qual = fns[-1].qualname if fns else "<module>"
    return f"{mod.path}:{qual}"


def _wire_facts(mod: ModuleIndex) -> Tuple[
    Dict[str, Set[str]], Dict[str, Set[str]], List[Tuple[str, int]]
]:
    """(producers, consumers, data_reads) for one module.

    producers/consumers map frame tag name -> site set; data_reads are
    (site, line) of every ``data_q.get``/``get_nowait`` call.
    """
    producers: Dict[str, Set[str]] = {}
    consumers: Dict[str, Set[str]] = {}
    data_reads: List[Tuple[str, int]] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            meth = node.func.attr
            if meth in ("put", "put_nowait") and node.args:
                for name in _frame_names(node.args[0]):
                    producers.setdefault(name, set()).add(
                        _site(mod, node.lineno)
                    )
            elif meth in ("get", "get_nowait") and \
                    "data_q" in _receiver_tail(node.func.value):
                data_reads.append((_site(mod, node.lineno), node.lineno))
        elif isinstance(node, ast.Compare):
            names: List[str] = []
            for side in (node.left, *node.comparators):
                names.extend(_frame_names(side))
            for name in names:
                consumers.setdefault(name, set()).add(
                    _site(mod, node.lineno)
                )
    return producers, consumers, data_reads


# ---------------------------------------------------------------------------
# the extraction pass
# ---------------------------------------------------------------------------

def extract_protocol(
    index: RepoIndex,
    root: Path,
    *,
    modules: Sequence[str] = PROTOCOL_MODULES,
    sim_path: str = SIM_PATH,
    event_manifest: str = EVENT_MANIFEST_PATH,
) -> Tuple[dict, List[Finding]]:
    """Extract the protocol manifest from the tree; returns
    (manifest, findings).  Findings cover unverifiable declarations and
    uncovered emit/mirror sites — everything *but* drift against the
    committed manifest (``extract_findings`` adds that).  ``modules``,
    ``sim_path`` and ``event_manifest`` (root-relative) name the runtime
    modules, the lifecycle enums' module and the event-schema manifest:
    the port's by default."""
    findings: List[Finding] = []
    enums = _enum_states(index, sim_path)

    # event vocabulary: the event-schema manifest (root-relative)
    vocab: Optional[Set[str]] = None
    ev_file = Path(root) / event_manifest
    if ev_file.is_file():
        try:
            vocab = set(json.loads(
                ev_file.read_text(encoding="utf-8"))["events"])
        except (json.JSONDecodeError, KeyError):
            findings.append(_finding(
                event_manifest, 1, "",
                "event manifest unreadable — protocol extraction has no "
                "event vocabulary",
            ))
    else:
        findings.append(_finding(
            event_manifest, 1, "",
            "event-schema manifest missing — protocol extraction has no "
            "event vocabulary",
        ))

    ignore = {"irm.pack"}
    declared: Dict[Tuple[str, str, str], dict] = {}  # (entity,event,dst)
    covered_events: Dict[str, Set[str]] = {}  # path -> {event@fn-qualname}
    all_producers: Dict[str, Set[str]] = {}
    all_consumers: Dict[str, Set[str]] = {}
    all_data_reads: List[Tuple[ModuleIndex, str, int]] = []

    for mod_path in modules:
        mod = index.module(mod_path)
        if mod is None:
            continue

        # -- declarations + their evidence --
        for fn in mod.functions:
            for decl, line in _decl_transitions(fn):
                symbol = fn.qualname
                if not decl.pop("_literal", True) or not all(
                    isinstance(decl[k], str)
                    for k in ("entity", "event", "src", "dst")
                ):
                    findings.append(_finding(
                        mod.path, line, symbol,
                        "@transition arguments must be string literals",
                    ))
                    continue
                entity, event = decl["entity"], decl["event"]
                if entity not in ENTITY_SPEC:
                    findings.append(_finding(
                        mod.path, line, symbol,
                        f"@transition entity {entity!r} is unknown "
                        f"(expected one of {sorted(ENTITY_SPEC)})",
                    ))
                    continue
                internal = "." not in event
                if not internal and vocab is not None and event not in vocab:
                    findings.append(_finding(
                        mod.path, line, symbol,
                        f"@transition event {event!r} is not registered in "
                        f"{event_manifest}",
                    ))
                    continue
                # state vocabulary check against the lifecycle enums
                enum_name = _ENUM_FOR_ENTITY.get(entity)
                spec = ENTITY_SPEC[entity]
                if enum_name and enum_name in enums:
                    legal = enums[enum_name] | {spec["initial"]}
                    for st in (*decl["src"].split("|"), decl["dst"]):
                        if st not in legal:
                            findings.append(_finding(
                                mod.path, line, symbol,
                                f"@transition state {st!r} is not a "
                                f"{enum_name} member (have "
                                f"{sorted(legal)})",
                            ))
                # evidence: an emit of the event, or a reference to the
                # destination enum member (mirror assignment / guard)
                emits = {ev for ev, _ in _emit_events(fn.node)}
                refs = _enum_refs(fn.node)
                has_emit = event in emits
                has_state = enum_name is not None and any(
                    en == enum_name and member.lower() == decl["dst"]
                    for en, member in refs
                )
                if not (has_emit or has_state):
                    findings.append(_finding(
                        mod.path, line, symbol,
                        f"stale @transition: no bus.emit({event!r}) and no "
                        f"{decl['dst']!r} state reference in this function "
                        f"— the declaration has no evidence in the code",
                    ))
                    continue
                key = (entity, event, decl["dst"])
                site = f"{mod.path}:{fn.qualname}"
                merged = declared.get(key)
                if merged is None:
                    declared[key] = {
                        "src": set(decl["src"].split("|")),
                        "failing": bool(decl["failing"]),
                        "scope": decl["scope"],
                        "sites": {site},
                    }
                else:
                    if (bool(decl["failing"]), decl["scope"]) != (
                        merged["failing"], merged["scope"]
                    ):
                        findings.append(_finding(
                            mod.path, line, symbol,
                            f"conflicting @transition flags for "
                            f"{entity}/{event}->{decl['dst']} across "
                            f"declaration sites",
                        ))
                    merged["src"].update(decl["src"].split("|"))
                    merged["sites"].add(site)
                covered_events.setdefault(mod.path, set()).add(
                    f"{event}@{fn.qualname}"
                )

        # -- obligation 1: every protocol emit site is declared --
        for event, line in _emit_events(mod.tree):
            if event in ignore or (vocab is not None and event not in vocab):
                continue  # non-protocol / R6's problem
            entity = event.split(".", 1)[0]
            if entity not in ENTITY_SPEC:
                continue
            fns = _enclosing_functions(mod, line)
            cov = covered_events.get(mod.path, set())
            if not any(f"{event}@{fn.qualname}" in cov for fn in fns):
                symbol = fns[-1].qualname if fns else ""
                findings.append(_finding(
                    mod.path, line, symbol,
                    f"emit of {event!r} is not covered by a @transition "
                    f"declaration — the extractor cannot see this "
                    f"transition; declare it on the enclosing function",
                ))

        # -- obligation 2: every mirror assignment is declared --
        for enum_name, member, line in _mirror_assignments(mod.tree):
            entity = {"PEState": "pe", "WorkerState": "worker"}[enum_name]
            dst = member.lower()
            fns = _enclosing_functions(mod, line)
            ok = False
            for fn in fns:
                for decl, _l in _decl_transitions(fn):
                    if decl.get("entity") == entity and decl.get("dst") == dst:
                        ok = True
            if not ok:
                symbol = fns[-1].qualname if fns else ""
                findings.append(_finding(
                    mod.path, line, symbol,
                    f"mirror assignment .state = {enum_name}.{member} is "
                    f"not covered by a @transition(entity={entity!r}, ..., "
                    f"dst={dst!r}) on the enclosing function",
                ))

        # -- wire frames --
        prod, cons, reads = _wire_facts(mod)
        for name, sites in prod.items():
            all_producers.setdefault(name, set()).update(sites)
        for name, sites in cons.items():
            all_consumers.setdefault(name, set()).update(sites)
        all_data_reads.extend((mod, s, line) for s, line in reads)

    # single-consumer: every data-channel read runs in @loop_only code
    for mod, site, line in all_data_reads:
        fns = _enclosing_functions(mod, line)
        if not fns or not fns[-1].loop_only:
            findings.append(_finding(
                mod.path, line, fns[-1].qualname if fns else "",
                "data-channel read outside a @loop_only function breaks "
                "the single-consumer invariant",
            ))

    machines: Dict[str, Machine] = {}
    for entity, spec in ENTITY_SPEC.items():
        transitions = [
            Transition(
                entity=entity,
                event=event,
                src=tuple(sorted(d["src"])),
                dst=dst,
                failing=d["failing"],
                scope=d["scope"],
                sites=tuple(sorted(d["sites"])),
            )
            for (ent, event, dst), d in declared.items()
            if ent == entity
        ]
        if not transitions:
            continue
        machines[entity] = Machine(
            entity=entity,
            key=tuple(spec["key"]),
            initial=str(spec["initial"]),
            terminal=tuple(spec["terminal"]),
            transitions=transitions,
        )

    wire = {
        "frames": {
            name: {
                "channel": "data" if name.startswith("_EV_") else "cmd",
                "producers": sorted(all_producers.get(name, ())),
                "consumers": sorted(all_consumers.get(name, ())),
            }
            for name in sorted(set(all_producers) | set(all_consumers))
        },
        "data_readers": sorted({
            s for _m, s, _l in all_data_reads
        }),
    }
    return machines_to_manifest(machines, wire), findings


def extract_findings(index: RepoIndex, root: Path) -> List[Finding]:
    """Extraction findings + drift against the committed manifest."""
    manifest, findings = extract_protocol(index, root)
    committed_file = Path(root) / PROTOCOL_MANIFEST_PATH
    if not committed_file.is_file():
        findings.append(_finding(
            PROTOCOL_MANIFEST_PATH, 1, "",
            "protocol manifest is missing from the tree — regenerate with "
            "python -m repro_torch.analysis.protocol extract --write",
        ))
        return findings
    try:
        committed = json.loads(committed_file.read_text(encoding="utf-8"))
    except json.JSONDecodeError as exc:
        findings.append(_finding(
            PROTOCOL_MANIFEST_PATH, 1, "",
            f"protocol manifest is not valid JSON: {exc.msg}",
        ))
        return findings
    for line in diff_manifests(manifest, committed):
        findings.append(_finding(
            PROTOCOL_MANIFEST_PATH, 1, "",
            f"protocol drift: {line} — regenerate with python -m "
            f"repro_torch.analysis.protocol extract --write",
        ))
    return findings
