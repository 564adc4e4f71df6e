"""What the benchmark imports, by an AST walk of every module under
portbench/: no module's top-level import name, compared whole, is jax,
jaxlib, flax or repro (repro_torch is another name), and nothing under
reference/, data/ or workcount/ imports repro_torch."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("reference", "data", "workcount")


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


MODULES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert _imports(path).isdisjoint(FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in MODULES if p.relative_to(BENCH).parts[0] in YARDSTICK],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in _imports(path)


def test_the_walk_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom jax.numpy import zeros\n")
    assert _imports(f) == {"repro_torch", "jax"}


def test_nothing_reads_the_jax_benchmarks():
    """What a run executes (every module but the tests) names neither the
    JAX package's benchmarks/ folder nor a module of it."""
    for p in MODULES:
        if p.relative_to(BENCH).parts[0] != "tests":
            assert "benchmarks" not in _imports(p) and "benchmarks/" not in p.read_text(), p
