"""What the benchmark's modules import, compared by whole top-level names
(``curvlinops_tpu_torch`` begins with ``curvlinops_tpu``): nothing under
``perfbench/`` imports JAX or the JAX package, and nothing under
``perfbench/reference/`` imports the program either."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(HERE.rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "curvlinops_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    imports = top_level_imports(path)
    assert "curvlinops_tpu_torch" not in imports
    assert imports <= {"__future__", "contextlib", "math", "torch"}


def test_the_check_is_by_whole_names():
    assert "curvlinops_tpu_torch".split(".")[0] not in JAX
