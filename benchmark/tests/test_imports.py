"""No module of the benchmark imports jax or the JAX package (top-level
names compared whole: parelag_tpu_torch is the port), and the plain
references import nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "parelag_tpu"}


def top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert top_imports(path) <= {"numpy", "torch"}


def test_whole_names():
    assert "parelag_tpu_torch".split(".")[0] not in BANNED
