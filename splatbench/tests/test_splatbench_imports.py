"""Nothing under splatbench imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference imports nothing of the program."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "splat_tpu"}


def _imports(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "splat_tpu_torch" not in _imports(path)
    assert "splat_tpu_torch" not in path.read_text()


def test_run_process_check(monkeypatch):
    import sys

    from splatbench import harness

    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_loaded()
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "splat_tpu_torch_extra", object())
    assert "splat_tpu" not in harness.forbidden_loaded()
