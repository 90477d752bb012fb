"""R5 — determinism lint over ``core/``, ``runtime/``, and ``obs/``.

The port's ``core.sim`` is held bit for bit to the JAX package's, and
every pinned scenario metric assumes it is a pure function of
``(stream, config, seed)``.  Three classes of construct silently break
that:

- **wall-clock reads** — ``time.time()``/``monotonic()``/
  ``perf_counter()`` (and ``datetime.now``) leak host timing into
  results;
- **ambient RNG** — the stdlib ``random`` module and numpy's legacy
  global-state API (``np.random.normal`` etc.) draw from hidden, shared
  state; even ``np.random.default_rng()`` *without a seed* is
  nondeterministic.  So is torch's global generator: ``torch.manual_seed``
  and ``torch.cuda.manual_seed(_all)`` seed it, and ``torch.rand`` /
  ``randn`` / ``randint`` / ``randperm`` / ``normal`` / ``bernoulli`` /
  ``multinomial`` draw from it unless given a ``generator=``.  All
  randomness must flow through a ``default_rng(seed)`` generator (or a
  seeded ``torch.Generator``) handed down explicitly;
- **set-order iteration** — ``for x in {…}`` / ``in set(...)`` iterates
  in hash order, which varies across runs with ``PYTHONHASHSEED``; sets
  must be sorted before iteration (dicts are insertion-ordered and
  fine).

Scope, per tree:

- ``src/repro_torch/core/`` — the packers, profiler, predictor, IRM, the
  simulator, and the Spark baseline all sit on the equivalence-pinned
  path.  **No exemptions**: results must be a pure function of
  ``(stream, config, seed)``.
- ``src/repro_torch/runtime/`` and ``src/repro_torch/obs/`` — decision
  logic here must stay replayable from recorded event logs, so the same
  three classes of construct are linted, with one carve-out: *measurement*
  sites may read the wall clock.  A wall-clock call is exempt when it
  sits inside a function annotated ``@worker_side`` or ``@loop_only``
  (declared timing/measurement affinity) or inside an ``async def``
  (the loop's plumbing, not decision logic), or anywhere in
  ``runtime/clock.py`` — the one sanctioned wall-clock wrapper
  (``ScaledClock``) — or in ``obs/spans.py``, the model path's one
  measurement clock (spans and counters stamped on the profiler's clock,
  recorded only while a profiler session records).  RNG and
  set-iteration checks get **no** exemption anywhere.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .model import Finding, ModuleIndex, RepoIndex

__all__ = ["check_determinism"]

CORE_PREFIX = "src/repro_torch/core/"
#: trees where wall-clock reads are linted but annotated measurement
#: sites (@worker_side / @loop_only / async def) are exempt
REPLAY_PREFIXES = ("src/repro_torch/runtime/", "src/repro_torch/obs/")
#: the sanctioned wall-clock readers — ScaledClock must read the host
#: clock, and the model path's spans the profiler's; everything else goes
#: through them
WALL_CLOCK_ALLOWED_MODULES = {"src/repro_torch/runtime/clock.py",
                              "src/repro_torch/obs/spans.py"}

_WALL_CLOCK = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "datetime.now",
    "datetime.utcnow",
    "datetime.today",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
}

#: The only members of ``np.random`` that are deterministic-by-design
#: (explicit generator construction / seeding machinery).
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64", "Philox"}

#: torch calls that seed its global generator: ambient RNG wherever they sit.
_TORCH_SEEDING = {"torch.manual_seed", "torch.cuda.manual_seed",
                  "torch.cuda.manual_seed_all"}
#: torch draws that read its global generator unless given ``generator=``.
_TORCH_DRAWS = {"torch.rand", "torch.randn", "torch.randint", "torch.randperm",
                "torch.normal", "torch.bernoulli", "torch.multinomial"}


def _dotted(node: ast.expr) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_set_expr(node: ast.expr) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


def _wall_clock_exempt(mod: ModuleIndex, line: int) -> bool:
    """True when ``line`` sits inside a declared measurement site: a
    ``@worker_side`` / ``@loop_only`` function or an ``async def``."""
    for fn in mod.functions:
        end = getattr(fn.node, "end_lineno", fn.node.lineno)
        if fn.node.lineno <= line <= end and (
            fn.worker_side or fn.loop_only or fn.is_async
        ):
            return True
    return False


def check_determinism(index: RepoIndex, root) -> List[Finding]:
    findings: List[Finding] = []
    for mod in index.modules.values():
        in_core = mod.path.startswith(CORE_PREFIX)
        in_replay = mod.path.startswith(REPLAY_PREFIXES)
        if not in_core and not in_replay:
            continue
        # does this module import the stdlib random module (and under
        # what name)?  numpy-as-np is assumed by repo convention.
        random_aliases = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "random":
                        random_aliases.add(alias.asname or "random")
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func)
                if dotted in _WALL_CLOCK:
                    if in_replay:
                        if (
                            mod.path not in WALL_CLOCK_ALLOWED_MODULES
                            and not _wall_clock_exempt(mod, node.lineno)
                        ):
                            findings.append(
                                Finding(
                                    rule="R5",
                                    path=mod.path,
                                    line=node.lineno,
                                    symbol="",
                                    message=(
                                        f"wall-clock read {dotted}() in "
                                        f"decision logic; route it through "
                                        f"ScaledClock, or annotate the "
                                        f"enclosing function @worker_side/"
                                        f"@loop_only if this is a "
                                        f"measurement site"
                                    ),
                                )
                            )
                    else:
                        findings.append(
                            Finding(
                                rule="R5",
                                path=mod.path,
                                line=node.lineno,
                                symbol="",
                                message=(
                                    f"wall-clock read {dotted}() on the sim path; "
                                    f"core/ results must be a pure function of "
                                    f"(stream, config, seed)"
                                ),
                            )
                        )
                elif dotted is not None:
                    head, _, rest = dotted.partition(".")
                    if head in random_aliases:
                        findings.append(
                            Finding(
                                rule="R5",
                                path=mod.path,
                                line=node.lineno,
                                symbol="",
                                message=(
                                    f"stdlib global RNG call {dotted}(); use an "
                                    f"explicit np.random.default_rng(seed) "
                                    f"generator threaded through the config"
                                ),
                            )
                        )
                    elif (
                        head in ("np", "numpy")
                        and rest.startswith("random.")
                        and rest.split(".")[1] not in _NP_RANDOM_OK
                    ):
                        findings.append(
                            Finding(
                                rule="R5",
                                path=mod.path,
                                line=node.lineno,
                                symbol="",
                                message=(
                                    f"numpy legacy global-state RNG {dotted}(); "
                                    f"draw from a seeded default_rng generator "
                                    f"instead"
                                ),
                            )
                        )
                    elif dotted in _TORCH_SEEDING or (
                        dotted in _TORCH_DRAWS
                        and not any(kw.arg == "generator" for kw in node.keywords)
                    ):
                        findings.append(
                            Finding(
                                rule="R5",
                                path=mod.path,
                                line=node.lineno,
                                symbol="",
                                message=(
                                    f"torch global-state RNG {dotted}(); draw "
                                    f"from a seeded torch.Generator passed as "
                                    f"generator=, or from a seeded default_rng"
                                ),
                            )
                        )
                    if dotted.endswith("default_rng") and not node.args:
                        findings.append(
                            Finding(
                                rule="R5",
                                path=mod.path,
                                line=node.lineno,
                                symbol="",
                                message=(
                                    "unseeded default_rng() on the sim path — "
                                    "pass the config's seed explicitly"
                                ),
                            )
                        )
            elif isinstance(node, ast.For) and _is_set_expr(node.iter):
                findings.append(
                    Finding(
                        rule="R5",
                        path=mod.path,
                        line=node.lineno,
                        symbol="",
                        message=(
                            "iteration over a set is hash-order-dependent "
                            "(varies with PYTHONHASHSEED); sort it or use an "
                            "insertion-ordered dict"
                        ),
                    )
                )
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
                for comp in node.generators:
                    if _is_set_expr(comp.iter):
                        findings.append(
                            Finding(
                                rule="R5",
                                path=mod.path,
                                line=node.lineno,
                                symbol="",
                                message=(
                                    "comprehension over a set is hash-order-"
                                    "dependent (varies with PYTHONHASHSEED); "
                                    "sort it first"
                                ),
                            )
                        )
    return findings
