"""Import hygiene of the port: no file of cednerf_torch, and neither
chip_smoke.py nor profile_serving.py, imports jax, flax or the JAX package
(cednerf_tpu)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cednerf_tpu"}
FILES = sorted((ROOT / "cednerf_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_serving.py"]


def _imported_roots(path):
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


def test_port_files_exist():
    assert len(FILES) > 15
    assert (ROOT / "cednerf_torch" / "csrc" / "brick_encode_fwd.cu").exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"
