"""Import hygiene of the port: no file of cednerf_torch, and none of
chip_smoke.py, profile_serving.py and profile_training.py, imports jax,
flax or the JAX package (cednerf_tpu)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cednerf_tpu"}
FILES = sorted((ROOT / "cednerf_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_serving.py",
    ROOT / "profile_training.py"]


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
    assert len(FILES) > 25
    for name in ("brick_encode_fwd", "brick_encode_bwd", "compact_select",
                 "scatter_add_rows", "row_gather"):
        assert (ROOT / "cednerf_torch" / "csrc" / f"{name}.cu").exists()
    for mod in ("engine/train.py", "ops/losses.py", "ops/segments.py",
                "ops/compact_kernels.py", "ops/scatter_kernels.py",
                "ops/gather_kernels.py", "tools/profile_interp_enc.py",
                "tools/profile_row_gather.py", "datasets/procedural.py"):
        assert (ROOT / "cednerf_torch" / mod).exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"
