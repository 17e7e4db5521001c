"""The port's last tools against their JAX counterparts: gen_isg_ist (the
same .npy files, bit for bit, on a 64x64 DyNeRF fixture), validate_prop
(the JAX tool's result keys, a shrunken run on the CPU) and vis.py
(NerfvisCallback's copy without nerfvis, make_eval_fn against the field's
forward)."""

import ast
import dataclasses
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from test_datasets import make_dynerf_fixture

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU ops in each of the suite's worker processes (as in
    tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"j_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("what", ["both", "isg"])
def test_gen_isg_ist_writes_the_jax_tools_files(tmp_path, monkeypatch, what):
    """The same flags and the same files, bit for bit: both tools on one
    64x64 fixture (3 cameras x 8 frames, 2 of them train) written twice, --factor 4,
    --gamma 1e-3 (the keyframe setting) and --frame_shift 3."""
    from cednerf_torch.tools import gen_isg_ist

    argv = ["--factor", "4", "--gamma", "1e-3", "--frame_shift", "3",
            "--what", what]
    files = {"isg": ["isg_weights.npy"],
             "both": ["isg_weights.npy", "ist_weights.npy"]}[what]
    roots = {}
    for side in ("jax", "port"):
        roots[side] = tmp_path / side
        make_dynerf_fixture(str(roots[side]), scene="cook_spinach",
                            n_cams=3, n_frames=8, wh=64)
    jtool = _load_jax_tool("gen_isg_ist")
    monkeypatch.setattr(sys, "argv", [
        "gen_isg_ist.py", "--data_root", str(roots["jax"]), "--scene",
        "cook_spinach"] + argv)
    jtool.main()
    gen_isg_ist.main(["--data_root", str(roots["port"]), "--scene",
                      "cook_spinach"] + argv)
    for name in files:
        want = np.load(roots["jax"] / "cook_spinach" / name)
        got = np.load(roots["port"] / "cook_spinach" / name)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (16, 64, 64)   # 2 train cameras
        np.testing.assert_array_equal(got, want)
    if what == "isg":
        assert not (roots["port"] / "cook_spinach" / "ist_weights.npy"
                    ).exists()
    jp = {a.dest: (a.option_strings, a.default, a.choices)
          for a in gen_isg_ist.build_parser()._actions}
    assert set(jp) == {"help", "data_root", "scene", "factor", "gamma",
                       "alpha", "frame_shift", "what"}


def _jax_result_keys(path):
    """The keys of the `result = {...}` dict of a JAX tool."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", "") == "result"):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no result dict in {path}")


def _jax_flags(path):
    """The option strings of a JAX tool's argparse calls."""
    tree = ast.parse(path.read_text())
    return {a.value for n in ast.walk(tree)
            if isinstance(n, ast.Call)
            and getattr(n.func, "attr", "") == "add_argument"
            for a in n.args if isinstance(a, ast.Constant)}


@pytest.mark.parametrize("host", [False, True])
def test_validate_prop_prints_the_jax_keys(monkeypatch, tmp_path, host):
    """The proposal-path validator on the CPU, shrunk (a 4-level field,
    16x16 ball scene, 64 rays, 4 steps): the JAX tool's flags (plus
    --device) and its JSON keys (plus the device, and the time-to-quality
    keys under --ttq_db), finite PSNRs, the PNGs; the scanned loop and
    --host."""
    from cednerf_torch.datasets.procedural import BallScene
    from cednerf_torch.engine.config import dnerf_config
    from cednerf_torch.tools import validate_prop as vp

    small = dict(target_sample_batch_size=4096, grid_resolution=16,
                 hash_dst_resolution=128, log2_hashmap_size=14,
                 max_table_rows=512, hash_n_levels=4)
    monkeypatch.setattr(vp, "dnerf_config", lambda max_steps: dataclasses
                        .replace(dnerf_config(max_steps), **small))
    monkeypatch.setattr(vp, "BallScene", lambda n_cams, wh, n_times:
                        BallScene(n_cams=4, wh=16, n_times=4))
    argv = ["--steps", "4", "--rays", "64", "--steps_per_call", "2",
            "--ttq_db", "0,60", "--device", "cpu", "--out", str(tmp_path)]
    res = vp.run(vp.build_parser().parse_args(argv + (["--host"] if host
                                                      else [])))
    jax_tool = REPO / "tools" / "validate_prop.py"
    assert set(res) == _jax_result_keys(jax_tool) | {
        "device", "ttq_s", "compile_s_estimate", "median_chunk_s"}
    port_flags = {s for a in vp.build_parser()._actions
                  for s in a.option_strings} - {"-h", "--help"}
    assert port_flags == _jax_flags(jax_tool) | {"--device"}
    assert res["loop"] == ("host" if host else "scanned") and res["steps"] == 4
    assert np.isfinite([res["final_train_psnr"], res["train_view_psnr"],
                        res["eval_psnr"], res["eval_psnr_raw"]]).all()
    # the scanned loop reads each chunk's PSNR; --host every 16th step (as
    # the JAX tool), so these 4 steps cross no threshold there
    assert (res["ttq_s"]["0"] is None) == host and res["ttq_s"]["60"] is None
    for name in ("eval_rgb.png", "eval_gt.png", "result.json"):
        assert (tmp_path / name).exists()


def test_vis_eval_fn_matches_the_field():
    """make_eval_fn: numpy (points, dirs) in, numpy (sigma [N, 1], rgb
    [N, 3]) out, the field's own forward at the given time (one chunk
    bit for bit, four within 1e-6); NerfvisCallback is the JAX vis.py's, and without
    nerfvis (not installed) it raises ImportError naming the package."""
    import vis as jvis
    from cednerf_torch import vis
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config

    cfg = dataclasses.replace(dnerf_config(), hash_dst_resolution=128,
                              log2_hashmap_size=14, max_table_rows=512,
                              hash_n_levels=4)
    field = build_field(cfg, ModelFlags(use_time_embedding=True,
                                        use_feat_predict=True),
                        device="cpu", seed=3)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.4, 1.4, (1000, 3)).astype(np.float32)
    dirs = rng.normal(size=(1000, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    sigma, rgb = vis.make_eval_fn(field, 0.25, "cpu")(pts, dirs)
    assert isinstance(sigma, np.ndarray) and isinstance(rgb, np.ndarray)
    assert sigma.shape == (1000, 1) and rgb.shape == (1000, 3)
    with torch.no_grad():
        x = torch.from_numpy(pts)
        want_rgb, res = field(x, torch.full((1000, 1), 0.25),
                              torch.from_numpy(dirs))
    np.testing.assert_array_equal(rgb, want_rgb.float().numpy())
    np.testing.assert_array_equal(sigma, res["density"].float().numpy())
    s2, c2 = vis.make_eval_fn(field, 0.25, "cpu", chunk=250)(pts, dirs)
    # four chunks: within 1e-6 (the matmuls' blocking follows the rows)
    np.testing.assert_allclose(s2, sigma, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c2, rgb, atol=1e-6)
    assert ({k for k in vars(vis.NerfvisCallback) if not k.startswith("__")}
            == {k for k in vars(jvis.NerfvisCallback)
                if not k.startswith("__")})
    with pytest.raises(ImportError, match="nerfvis"):
        vis.NerfvisCallback()
