"""What the benchmark's sources import, by whole top-level module name."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "monorec_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert "monorec_tpu_torch" not in top_level_imports(path)


def test_top_level_names_are_whole():
    """The port's name begins with the JAX package's; the check compares
    whole names."""
    from bench_h100 import harness

    assert "monorec_tpu" in harness.FORBIDDEN_MODULES
    assert "monorec_tpu_torch".split(".")[0] not in harness.FORBIDDEN_MODULES
