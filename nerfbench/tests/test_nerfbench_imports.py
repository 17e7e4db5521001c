"""Nothing under nerfbench/ imports JAX or the JAX package, and the
reference imports nothing of the measured program either; top-level module
names are compared whole (cednerf_torch begins with cednerf_)."""

import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cednerf_tpu", "bench"}
PROGRAM = {"cednerf_torch"}
FILES = sorted(p for p in PKG.rglob("*.py") if ".cache" not in p.parts)


def roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_files_found():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(PKG).as_posix())
def test_no_jax(path):
    assert not FORBIDDEN.intersection(roots(path))


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.relative_to(PKG).as_posix())
def test_reference_stands_alone(path):
    assert not (FORBIDDEN | PROGRAM).intersection(roots(path))


def test_whole_names():
    """cednerf_torch is allowed outside the reference; cednerf_tpu never,
    though both begin with cednerf_."""
    probe = PKG / "tests" / "test_nerfbench_imports.py"
    assert "cednerf_torch" not in FORBIDDEN
    assert not FORBIDDEN.intersection(roots(probe))
