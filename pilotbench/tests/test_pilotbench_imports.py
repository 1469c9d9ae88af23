"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), the reference
imports nothing of the program, and nothing reads ``benchmarks/``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(p for p in BENCH.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(top_level_imports(path))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_benchmarks(path):
    if path.parent.name == "tests":
        return
    assert "benchmarks" not in set(top_level_imports(path))
    assert "benchmarks/" not in path.read_text()


def test_the_guard_compares_whole_names():
    from pilotbench import harness
    assert "repro" in harness.FORBIDDEN and "repro_torch" not in harness.FORBIDDEN
    names = set(harness.forbidden_modules())
    assert "repro_torch" not in names
