"""What the protocol checker reads of the tree: findings and a parsed index.

The checker is stdlib-only (``ast``): it never imports the code it
analyses, it parses it.  ``RepoIndex`` parses a file the first time a rule
asks for it and records each function with:

- its dotted qualname (``Class.method`` / nested chains),
- whether it is ``@loop_only`` (``runtime.annotations``), nested functions
  inheriting the enclosing function's annotation,
- the raw AST node, for the rules to scan.

A file that fails to parse becomes a finding itself (rule ``parse``)
rather than a silent gap in coverage.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["Finding", "FunctionInfo", "ModuleIndex", "RepoIndex"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation."""

    rule: str          # "R7", "R8" or "parse"
    path: str          # repo-root-relative, forward slashes
    line: int
    symbol: str        # qualname of the enclosing function/class, or ""
    message: str

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def _decorator_name(node: ast.expr) -> Optional[str]:
    """The bare name of a decorator expression (``@x``, ``@m.x``, ``@x(...)``)."""
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


@dataclasses.dataclass
class FunctionInfo:
    """One ``def``/``async def`` with its ``@loop_only`` annotation resolved."""

    qualname: str                  # e.g. "MultiprocTransport._on_pull"
    node: ast.AST                  # FunctionDef | AsyncFunctionDef
    path: str                      # repo-relative file path
    loop_only: bool = False


class ModuleIndex:
    """Parsed view of one file: its tree plus every function in it."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.functions: List[FunctionInfo] = []
        self._collect(tree.body, qual_prefix="", loop_only=False)

    def _collect(self, body: Iterable[ast.stmt], qual_prefix: str, loop_only: bool) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = FunctionInfo(
                    qualname=qual_prefix + node.name,
                    node=node,
                    path=self.path,
                    loop_only=loop_only or any(
                        _decorator_name(d) == "loop_only" for d in node.decorator_list),
                )
                self.functions.append(info)
                self._collect(node.body, info.qualname + ".", info.loop_only)
            elif isinstance(node, ast.ClassDef):
                self._collect(node.body, qual_prefix + node.name + ".", loop_only)
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                # functions defined under guards (TYPE_CHECKING, try/except
                # import fallbacks) still count
                for child_body in _stmt_bodies(node):
                    self._collect(child_body, qual_prefix, loop_only)

    def classes(self) -> Dict[str, ast.ClassDef]:
        return {
            n.name: n
            for n in ast.walk(self.tree)
            if isinstance(n, ast.ClassDef)
        }


def _stmt_bodies(node: ast.stmt) -> List[List[ast.stmt]]:
    out: List[List[ast.stmt]] = []
    for field in ("body", "orelse", "finalbody"):
        got = getattr(node, field, None)
        if got:
            out.append(got)
    for handler in getattr(node, "handlers", []) or []:
        out.append(handler.body)
    return out


class RepoIndex:
    """The tree's files, each parsed on first use."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self._modules: Dict[str, Optional[ModuleIndex]] = {}
        self.parse_findings: List[Finding] = []

    def module(self, rel_path: str) -> Optional[ModuleIndex]:
        """The parsed file at ``rel_path`` (root-relative); None if it is
        missing or does not parse (a ``parse`` finding)."""
        if rel_path not in self._modules:
            self._modules[rel_path] = self._parse(rel_path)
        return self._modules[rel_path]

    def _parse(self, rel_path: str) -> Optional[ModuleIndex]:
        path = self.root / rel_path
        if not path.is_file():
            return None
        try:
            tree = ast.parse(path.read_text(encoding="utf-8"))
        except SyntaxError as exc:
            self.parse_findings.append(Finding(
                rule="parse", path=rel_path, line=exc.lineno or 0, symbol="",
                message=f"file does not parse: {exc.msg}"))
            return None
        return ModuleIndex(rel_path, tree)
