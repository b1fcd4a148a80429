"""Nothing under hbench/ imports JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and the
reference imports nothing of the program."""
from __future__ import annotations

import ast

import pytest

from hb_util import HBENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(HBENCH.rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HBENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "torch", "numpy"}


def test_whole_names_are_compared():
    import run
    assert run.forbidden_modules(["repro_torch", "repro_torch.core.hmatrix", "numpy",
                                  "jaxtyping", "reference.exact"]) == []
    assert run.forbidden_modules(["repro.core", "jaxlib.xla_client", "jax", "flax.linen"]) \
        == ["flax", "jax", "jaxlib", "repro"]
