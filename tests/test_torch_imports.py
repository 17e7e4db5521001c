"""Import hygiene of the port: no file of cednerf_torch, and none of
chip_smoke.py, profile_serving.py and profile_training.py, imports jax,
flax or the JAX package (cednerf_tpu); and the port builds only its own
C++ and CUDA sources."""

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
    for name in ("png_unfilter", "raysampler", "weights"):
        assert (ROOT / "cednerf_torch" / "csrc" / "host" / f"{name}.cpp"
                ).exists()
    for mod in ("engine/train.py", "ops/losses.py", "ops/segments.py",
                "ops/compact_kernels.py", "ops/scatter_kernels.py",
                "ops/gather_kernels.py", "tools/profile_interp_enc.py",
                "tools/profile_row_gather.py", "datasets/procedural.py",
                "datasets/camera.py", "datasets/dnerf_synthetic.py",
                "datasets/hypernerf.py", "datasets/dynerf.py",
                "datasets/llff.py", "datasets/native.py", "engine/cli.py",
                "engine/checkpoint.py", "engine/sampling.py",
                "utils/host_build.py", "utils/image.py", "train_real.py",
                "tools/validate_synthetic.py"):
        assert (ROOT / "cednerf_torch" / mod).exists()


def test_port_builds_only_its_own_sources():
    """Every C++ / CUDA source the port builds lies under cednerf_torch/csrc
    (the root csrc/ is the JAX package's), and no module of the port names
    a path that climbs out of the package to a csrc directory."""
    from cednerf_torch.datasets import native
    from cednerf_torch.ops import (compact_kernels, cuda_build,  # noqa: F401
                                   encode_kernels, gather_kernels,
                                   scatter_kernels)
    from cednerf_torch.utils import image
    own = (ROOT / "cednerf_torch" / "csrc").resolve()
    libs = list(cuda_build.LIBRARIES) + [native.SAMPLER, native.WEIGHTS,
                                         image.UNFILTER]
    assert len(libs) >= 8
    for lib in libs:
        src = pathlib.Path(lib.source).resolve()
        assert own in src.parents and src.exists(), src
    for path in sorted((ROOT / "cednerf_torch").rglob("*.py")):
        consts = [n.value for n in ast.walk(ast.parse(path.read_text()))
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)]
        assert not ("csrc" in consts and ".." in consts), path


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"
