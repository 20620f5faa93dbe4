"""Nothing under ``portbench/`` imports JAX or the JAX package, compared by
whole top-level name (``repro_torch`` is not ``repro``), and the plain
reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

from portbench.bench.harness import FORBIDDEN, forbidden_modules

BASE = Path(__file__).resolve().parents[1]
FILES = sorted(BASE.rglob("*.py"))


def _imported(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops.update(a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.partition(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).partition(".")[0])
    return tops


def test_files_found():
    names = {p.relative_to(BASE).as_posix() for p in FILES}
    assert {"run.py", "reference/sage.py", "drivers/gnn_full.py",
            "metrics/mfu.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(
    BASE).as_posix())
def test_no_jax_nor_the_jax_package(path):
    assert not _imported(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BASE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    tops = _imported(path)
    assert "repro_torch" not in tops
    assert tops <= {"__future__", "dataclasses", "functools", "math",
                    "statistics", "numpy", "scipy", "torch", "portbench"}


def test_a_whole_name_is_compared():
    assert forbidden_modules(["repro_torch", "repro_torch.engine",
                              "jaxtyping", "torch"]) == []
    assert forbidden_modules(["repro.core", "jax.numpy", "flax",
                              "repro_torch"]) == ["flax", "jax", "repro"]
