"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast

import pytest

from lutvq_bench.core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_lutvq"}


def imported(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(spec.BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(spec.BENCH)) for p in FILES])
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


def test_whole_name_comparison():
    assert "tpu_lutvq_torch".split(".")[0] not in FORBIDDEN
    assert any("tpu_lutvq_torch" in imported(p) for p in FILES)  # the harness does import the port


@pytest.mark.parametrize("path", sorted((spec.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_torch_alone(path):
    assert imported(path) <= {"__future__", "math", "torch"}
