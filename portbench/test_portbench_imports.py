"""Nothing of the benchmark imports JAX or the JAX package (``repro``), by
top-level module names compared whole, and the reference imports nothing
of the port; the run's own look at ``sys.modules`` the same way."""

import ast

import pytest

from portbench.conftest import PACKAGE
from portbench.harness import forbidden_modules

FILES = sorted(PACKAGE.rglob("*.py"))


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


@pytest.mark.parametrize("path", sorted((PACKAGE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in imported_tops(path)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level == 2:
            names = [node.module] if node.module else [a.name for a in node.names]
            assert set(names) <= {"traffic", "weights"}, names


def test_the_run_looks_at_whole_top_level_names():
    assert forbidden_modules(["repro_torch", "repro_torch.models", "numpy"]) == []
    assert forbidden_modules(["repro.core.sim", "jaxlib.xla", "reproduce"]) == ["jaxlib", "repro"]
    assert forbidden_modules(["flax"]) == ["flax"]
