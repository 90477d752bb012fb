"""What the invariant checker reads of the tree: findings and a parsed index.

The checker is stdlib-only (``ast``): it never imports the code it
analyses, it parses it.  ``RepoIndex`` walks the port's trees
(``ANALYZED_TREES``) once, parses every ``.py`` file in them, and records
each function with:

- its dotted qualname (``Class.method`` / nested chains),
- whether it is an ``async def``,
- its affinity annotations (``@loop_only`` / ``@worker_side`` from
  ``runtime.annotations``, and the ``@loop_only(blocking=...)`` reason),
  nested functions inheriting the enclosing function's annotations (a
  thread target defined inside a ``@worker_side`` entry point is
  worker-side too),
- the raw AST node, for the rules to scan.

A file outside those trees (a rule pointed at another package's paths)
is parsed the first time a rule asks for it.  A file that fails to parse
becomes a finding itself (rule ``parse``) rather than a silent gap in
coverage.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "ANALYZED_TREES",
    "SRC_PREFIX",
    "Finding",
    "FunctionInfo",
    "ModuleIndex",
    "RepoIndex",
    "load_packaged_json",
]

#: The port's trees, as globs relative to the repo root.  The JAX package
#: and its tests are ``python -m repro.analysis``'s.
ANALYZED_TREES = (
    "src/repro_torch/**/*.py",
    "tests/test_torch_*.py",
    "examples/torch_*.py",
    "tools/**/*.py",
    "chip_smoke.py",
)
#: Call edges resolve only into functions under this prefix.
SRC_PREFIX = "src/repro_torch/"

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation, stable enough to key a suppression on."""

    rule: str          # "R1".."R8" or "parse"
    path: str          # repo-root-relative, forward slashes
    line: int
    symbol: str        # qualname of the enclosing function/class, or ""
    message: str

    def key(self) -> str:
        """Baseline key: everything except the line number, so a pure
        line-shift (edits above the finding) cannot invalidate a
        suppression while an actual content change does."""
        return f"{self.rule}:{self.path}:{self.symbol}:{self.message}"

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


def _blocking_reason(node: ast.expr) -> Tuple[bool, Optional[str]]:
    """(has_blocking_kwarg, reason) for a ``@loop_only(blocking=...)`` call."""
    if not isinstance(node, ast.Call):
        return False, None
    for kw in node.keywords:
        if kw.arg == "blocking":
            if isinstance(kw.value, ast.Constant) and isinstance(kw.value.value, str):
                return True, kw.value.value
            return True, None
    return False, None


@dataclasses.dataclass
class FunctionInfo:
    """One ``def``/``async def`` with its affinity annotations resolved."""

    qualname: str                  # e.g. "MultiprocTransport._on_pull"
    node: ast.AST                  # FunctionDef | AsyncFunctionDef
    path: str                      # repo-relative file path
    loop_only: bool = False
    name: str = ""
    is_async: bool = False
    worker_side: bool = False
    blocking_reason: Optional[str] = None   # set iff @loop_only(blocking=...)
    has_blocking_kwarg: bool = False
    parent: Optional["FunctionInfo"] = None  # enclosing function, if nested

    @property
    def line(self) -> int:
        return self.node.lineno

    def allows_blocking(self) -> bool:
        return self.worker_side or (self.loop_only and bool(self.blocking_reason))


class ModuleIndex:
    """Parsed view of one file: its tree plus every function in it."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.functions: List[FunctionInfo] = []
        self._collect(tree.body, qual_prefix="", parent=None)

    def _collect(self, body: Iterable[ast.stmt], qual_prefix: str,
                 parent: Optional[FunctionInfo]) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = FunctionInfo(
                    qualname=qual_prefix + node.name,
                    node=node,
                    path=self.path,
                    name=node.name,
                    is_async=isinstance(node, ast.AsyncFunctionDef),
                    parent=parent,
                )
                for dec in node.decorator_list:
                    dname = _decorator_name(dec)
                    if dname == "loop_only":
                        info.loop_only = True
                        info.has_blocking_kwarg, info.blocking_reason = _blocking_reason(dec)
                    elif dname == "worker_side":
                        info.worker_side = True
                # nested defs inherit the enclosing affinity (a thread
                # target inside a @worker_side entry point is worker-side)
                if parent is not None:
                    info.loop_only = info.loop_only or parent.loop_only
                    info.worker_side = info.worker_side or parent.worker_side
                    if info.blocking_reason is None:
                        info.blocking_reason = parent.blocking_reason
                self.functions.append(info)
                self._collect(node.body, info.qualname + ".", info)
            elif isinstance(node, ast.ClassDef):
                self._collect(node.body, qual_prefix + node.name + ".", parent)
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                # functions defined under guards (TYPE_CHECKING, try/except
                # import fallbacks) still count
                for child_body in _stmt_bodies(node):
                    self._collect(child_body, qual_prefix, parent)

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
    """Every parsed module of the analyzed trees, plus name-based lookup."""

    def __init__(self, root: Path, trees: Iterable[str] = ANALYZED_TREES):
        self.root = Path(root)
        #: the walked trees' modules, by root-relative path
        self.modules: Dict[str, ModuleIndex] = {}
        self.parse_findings: List[Finding] = []
        self._elsewhere: Dict[str, Optional[ModuleIndex]] = {}
        for pattern in trees:
            for py in sorted(self.root.glob(pattern)):
                rel = py.relative_to(self.root)
                if _SKIP_DIRS.intersection(rel.parts) or not py.is_file():
                    continue
                mod = self._parse(rel.as_posix())
                if mod is None:
                    self._elsewhere[rel.as_posix()] = None  # parsed once: no second finding
                else:
                    self.modules[mod.path] = mod
        # name -> every port function with that name (call resolution never
        # follows edges into tests, tools or examples).  Functions nested
        # inside another function are excluded: they are local names,
        # unreachable by attribute/name from any other scope, so letting
        # them shadow a module-level or method name only fabricates edges
        # that cannot exist.
        self._by_name: Dict[str, List[FunctionInfo]] = {}
        for fn in self.src_functions(SRC_PREFIX):
            if fn.parent is None:
                self._by_name.setdefault(fn.name, []).append(fn)

    def src_functions(self, prefix: str = SRC_PREFIX) -> List[FunctionInfo]:
        """Every function of the walked modules whose path starts with ``prefix``."""
        out: List[FunctionInfo] = []
        for mod in self.modules.values():
            if mod.path.startswith(prefix):
                out.extend(mod.functions)
        return out

    def resolve_call(self, name: str) -> List[FunctionInfo]:
        """Every port function a call to ``name`` might reach.

        Name-based over-approximation: ``pool.kill_worker(...)`` resolves
        to *every* ``kill_worker`` under ``src/repro_torch/`` — exactly
        what a multi-implementation interface (``Transport``) needs, at the
        cost of occasionally traversing an unrelated same-named function.
        """
        return self._by_name.get(name, [])

    def module(self, rel_path: str) -> Optional[ModuleIndex]:
        """The parsed file at ``rel_path`` (root-relative); None if it is
        missing or does not parse (a ``parse`` finding)."""
        if rel_path in self.modules:
            return self.modules[rel_path]
        if rel_path not in self._elsewhere:
            self._elsewhere[rel_path] = self._parse(rel_path)
        return self._elsewhere[rel_path]

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


def load_packaged_json(filename: str) -> dict:
    """Load a JSON data file shipped inside ``repro_torch.analysis``."""
    here = Path(__file__).resolve().parent
    with open(here / filename, encoding="utf-8") as fh:
        return json.load(fh)
