"""What the benchmark may import: never JAX or the JAX package (top-level
names compared whole, so ``repro_torch`` is not ``repro``), never the
JAX package's benchmarks; and its reference nothing of the program."""

import ast
from pathlib import Path

import pytest

CTBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


FILES = sorted(CTBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    CTBENCH)))
def test_ctbench_imports_no_jax(path):
    bad = sorted(set(_imports(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((CTBENCH / "reference").rglob(
    "*.py")), ids=lambda p: p.name)
def test_ctbench_reference_imports_nothing_of_the_program(path):
    mods = set(_imports(path))
    assert mods <= {"__future__", "math", "torch"}, mods


def test_ctbench_names_compared_whole():
    from ctbench.core import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.api", "reproX",
                              "torch", "jax_stand_in"]) == []
    assert forbidden_modules(["repro.core", "jax.numpy", "flax",
                              "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "repro"]
