"""R3 (frozen-reference guard) and R4 (wire-contract drift).

R3 — ``src/repro/core/sim_reference.py`` is the pre-refactor simulator
the tick-for-tick equivalence suite pins ``repro.core.sim`` against, and
the port's ``simulate`` is held bit for bit to ``repro.core.sim``: the
port has no reference of its own, it is held to that one.  Its whole
value is that it never changes: the rule pins its content by SHA-256
(``frozen_manifest.json``, at the JAX package's hash) and finds every
import of it in the port's trees, whose allowlist is empty.  A drive-by
edit or a convenience import is a finding.

R4 — every class the multiproc transport pickles across the process
boundary has its field set registered in ``wire_manifest.json``.  Adding
a field silently widens the wire format: old pickles stop carrying it,
mixed-version master/worker pairs disagree, and the contract suite
(``tests/test_torch_wire_contract.py``) no longer proves round-trip fidelity.
The rule compares each class's AST field set (dataclass annotations or
``__slots__``) against the manifest *and* requires every registered
field to be exercised by the contract test.
"""

from __future__ import annotations

import ast
import hashlib
from pathlib import Path
from typing import List, Optional, Set

from .model import Finding, RepoIndex, load_packaged_json

__all__ = ["check_frozen_reference", "check_wire_contract"]


def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _import_hits(tree: ast.Module, module_name: str, symbols: Set[str]) -> List[int]:
    """Lines importing ``module_name`` (by module path) or any of ``symbols``."""
    lines: List[int] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if module_name in alias.name.split("."):
                    lines.append(node.lineno)
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if module_name in mod.split("."):
                lines.append(node.lineno)
                continue
            for alias in node.names:
                if alias.name in symbols:
                    lines.append(node.lineno)
                    break
    return lines


def check_frozen_reference(index: RepoIndex, root) -> List[Finding]:
    """R3: content-hash pin + import allowlist for frozen files."""
    findings: List[Finding] = []
    manifest = load_packaged_json("frozen_manifest.json")
    for entry in manifest["frozen"]:
        rel = entry["path"]
        target = Path(root) / rel
        mod_name = Path(rel).stem
        if target.is_file():
            actual = _sha256(target)
            if actual != entry["sha256"]:
                findings.append(
                    Finding(
                        rule="R3",
                        path=rel,
                        line=1,
                        symbol="",
                        message=(
                            f"frozen file modified (sha256 {actual[:12]}… != "
                            f"pinned {entry['sha256'][:12]}…): {entry['reason']} "
                            f"If the change is truly intended, re-pin the hash "
                            f"in src/repro_torch/analysis/frozen_manifest.json in the "
                            f"same commit and say why in the commit message."
                        ),
                    )
                )
        else:
            findings.append(
                Finding(
                    rule="R3",
                    path=rel,
                    line=1,
                    symbol="",
                    message="frozen file is missing from the tree",
                )
            )
        allow = set(entry["import_allowlist"]) | {rel}
        symbols = set(entry.get("symbols", ()))
        for mod in index.modules.values():
            if mod.path in allow:
                continue
            for line in _import_hits(mod.tree, mod_name, symbols):
                findings.append(
                    Finding(
                        rule="R3",
                        path=mod.path,
                        line=line,
                        symbol="",
                        message=(
                            f"import of frozen reference {mod_name} outside "
                            f"the equivalence/parity allowlist; the reference "
                            f"sim exists only to pin the fast sim — import "
                            f"repro_torch.core.sim instead"
                        ),
                    )
                )
    return findings


def _dataclass_fields(cls: ast.ClassDef) -> List[str]:
    out: List[str] = []
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if not node.target.id.startswith("_"):
                out.append(node.target.id)
    return out


def _slots_fields(cls: ast.ClassDef) -> Optional[List[str]]:
    for node in cls.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "__slots__":
                    if isinstance(node.value, (ast.Tuple, ast.List)):
                        return [
                            e.value
                            for e in node.value.elts
                            if isinstance(e, ast.Constant) and isinstance(e.value, str)
                        ]
    return None


def _test_tokens(tree: ast.Module) -> Set[str]:
    """Every attribute name, keyword-arg name, and string constant the
    contract test touches — a field counts as exercised if it appears as
    any of the three."""
    tokens: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            tokens.add(node.attr)
        elif isinstance(node, ast.keyword) and node.arg:
            tokens.add(node.arg)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            tokens.add(node.value)
    return tokens


def check_wire_contract(index: RepoIndex, root) -> List[Finding]:
    """R4: pickled-class field sets match the wire manifest + are tested."""
    findings: List[Finding] = []
    manifest = load_packaged_json("wire_manifest.json")
    test_path = manifest["contract_test"]
    test_mod = index.module(test_path)
    tokens = _test_tokens(test_mod.tree) if test_mod is not None else None
    if test_mod is None:
        findings.append(
            Finding(
                rule="R4",
                path=test_path,
                line=1,
                symbol="",
                message="wire-contract test file is missing",
            )
        )
    for cls_name, spec in manifest["classes"].items():
        mod = index.module(spec["path"])
        if mod is None:
            findings.append(
                Finding(
                    rule="R4",
                    path=spec["path"],
                    line=1,
                    symbol=cls_name,
                    message="wire-manifest class's module is missing",
                )
            )
            continue
        cls = mod.classes().get(cls_name)
        if cls is None:
            findings.append(
                Finding(
                    rule="R4",
                    path=spec["path"],
                    line=1,
                    symbol=cls_name,
                    message="wire-manifest class not found in its module",
                )
            )
            continue
        if spec["kind"] == "slots":
            fields = _slots_fields(cls) or []
        else:
            fields = _dataclass_fields(cls)
        declared = set(spec["fields"])
        actual = set(fields)
        for extra in sorted(actual - declared):
            findings.append(
                Finding(
                    rule="R4",
                    path=spec["path"],
                    line=cls.lineno,
                    symbol=cls_name,
                    message=(
                        f"wire-contract drift: field {extra!r} of {cls_name} "
                        f"crosses the transport but is not registered in "
                        f"wire_manifest.json — register it AND extend "
                        f"{test_path} to round-trip it"
                    ),
                )
            )
        for missing in sorted(declared - actual):
            findings.append(
                Finding(
                    rule="R4",
                    path=spec["path"],
                    line=cls.lineno,
                    symbol=cls_name,
                    message=(
                        f"stale wire manifest: {cls_name}.{missing} is "
                        f"registered but no longer exists on the class"
                    ),
                )
            )
        if tokens is not None:
            for field in sorted(declared & actual):
                if field not in tokens:
                    findings.append(
                        Finding(
                            rule="R4",
                            path=test_path,
                            line=1,
                            symbol=cls_name,
                            message=(
                                f"wire field {cls_name}.{field} is never "
                                f"exercised by the contract test — a pickle "
                                f"regression on it would go unnoticed"
                            ),
                        )
                    )
    return findings
