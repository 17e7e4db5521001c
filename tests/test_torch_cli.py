"""The port's CLI flag surface against the JAX package's: the same flags,
short forms, defaults and choices (engine/cli.py and train_real.py's own),
and for a set of command lines the same ModelFlags and the same SceneConfig
after apply_perf_overrides, field by field. Every value has its path in
the port: --dp, the last to raise, trains on a one-rank mesh."""

import argparse
import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from cednerf_tpu.engine import cli as j_cli
from cednerf_tpu.engine.config import config_for_scene as j_config_for_scene
from cednerf_torch import train_real
from cednerf_torch.engine import cli
from cednerf_torch.engine.config import config_for_scene

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Hundreds of small CPU ops: with torch's default of one thread per
    core in each of the suite's worker processes the threads oversubscribe
    the cores (as in tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _surface(parser):
    """{dest: (option strings, default, choices, type, const)} of a parser's
    optional arguments (help texts aside)."""
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     a.const)
            for a in parser._actions if a.option_strings and a.dest != "help"}


def _jax_train_real_parser(monkeypatch):
    """The parser the JAX package's train_real.py main() builds (taken at
    its parse_args call, before anything runs)."""
    spec = importlib.util.spec_from_file_location("j_train_real",
                                                  REPO / "train_real.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Built(Exception):
        pass

    def stop(self, *a, **k):
        raise Built(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(Built) as got:
        mod.main()
    return got.value.args[0]


def test_model_args_match_jax():
    got = _surface(cli.get_model_args(argparse.ArgumentParser()))
    want = _surface(j_cli.get_model_args(argparse.ArgumentParser()))
    assert got == want


def test_train_real_flags_match_jax(monkeypatch):
    """python -m cednerf_torch.train_real takes train_real.py's flags, plus
    --device (default cuda) and --seed (default 42, the JAX CLI's fixed
    seed)."""
    got = _surface(train_real.build_parser())
    want = _surface(_jax_train_real_parser(monkeypatch))
    assert got.pop("device") == (("--device",), "cuda", None, str, None)
    assert got.pop("seed") == (("--seed",), 42, None, int, None)
    # the dataset default is a path under the working directory
    assert got.pop("data_root")[0] == want.pop("data_root")[0]
    assert got == want


ARGVS = {
    "published": ["-te", "-ta", "-f", "-ae", "-df", "-d"],
    "reference_split": ["-te", "--hash_levels", "16", "--hash_features", "2"],
    "short_forms": ["-w", "-o", "-wr", "-ms", "1e-3", "--acc_entorpy_loss"],
    "hash4d": ["-te", "--grid_type", "hash4d"],
    "sample_budget": ["--sample_budget", "524288"],
    "scatter_impl": ["--scatter_impl", "onehot"],
    "interp_impl": ["--interp_impl", "xla"],
    "fine_table_rows": ["--fine_table_rows", "65536"],
    "compact_impl": ["--compact_impl", "xla"],
    "max_table_rows": ["--max_table_rows", "32768"],
    "row_layout_brick": ["--row_layout", "brick"],
    "steady_march_steps": ["--steady_march_steps", "0"],
    "all_overrides": ["-te", "-ta", "--sample_budget", "131072",
                      "--scatter_impl", "fused", "--compact_impl", "rayfold",
                      "--max_table_rows", "8192", "--steady_march_steps",
                      "384", "--fine_table_rows", "32768"],
}


def _cfg(scene, args, cli_mod, for_scene):
    """train_real.py's config chain: the preset, the encoder split, the
    perf overrides."""
    cfg = for_scene(scene, None)
    if args.hash_levels or args.hash_features:
        cfg = dataclasses.replace(
            cfg, hash_n_levels=args.hash_levels or cfg.hash_n_levels,
            hash_n_features=args.hash_features or cfg.hash_n_features)
    return cli_mod.apply_perf_overrides(cfg, args)


@pytest.mark.parametrize("scene", ["lego", "vrig_chicken", "cook_spinach"])
@pytest.mark.parametrize("name", list(ARGVS))
def test_flags_and_config_match_jax(name, scene):
    argv = ARGVS[name]
    args = cli.get_model_args(argparse.ArgumentParser()).parse_args(argv)
    jargs = j_cli.get_model_args(argparse.ArgumentParser()).parse_args(argv)
    assert vars(args) == vars(jargs)
    assert (dataclasses.asdict(cli.flags_from_args(args))
            == dataclasses.asdict(j_cli.flags_from_args(jargs)))
    got = _cfg(scene, args, cli, config_for_scene)
    want = _cfg(scene, jargs, j_cli, j_config_for_scene)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("argv,item", [
    (["--grid_type", "triplane"], 6), (["--hash4motion"], 6),
    (["--row_layout", "cell"], 6), (["--remat_feats"], 6)])
def test_unported_values_raise(argv, item):
    """The four values that raised until ROADMAP.md Queue 1 item `item`
    ported them: the CLI chain (flags, then the perf overrides) gives the
    JAX package's ModelFlags and SceneConfig, the field builds from them,
    and train_real.main gets past them to the dataset (missing here)."""
    args = cli.get_model_args(argparse.ArgumentParser()).parse_args(argv)
    jargs = j_cli.get_model_args(argparse.ArgumentParser()).parse_args(argv)
    flags = cli.flags_from_args(args)
    assert (dataclasses.asdict(flags)
            == dataclasses.asdict(j_cli.flags_from_args(jargs)))
    cfg = _cfg("lego", args, cli, config_for_scene)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        _cfg("lego", jargs, j_cli, j_config_for_scene)), item
    field = cli.build_field(cfg, flags, device="cpu")
    assert (field.grid_type, field.hash4motion) == (flags.grid_type,
                                                    flags.hash4motion)
    with pytest.raises(FileNotFoundError, match="transforms_test.json"):
        train_real.main(["--scene", "lego", "--device", "cpu",
                         "--data_root", str(REPO / "no_such_dataset")]
                        + argv)


def test_dp_raises(tmp_path, monkeypatch):
    """--dp raised until the ray-parallel slice of the port; now it trains:
    a one-rank run on the CPU (make_mesh's own gloo group, so
    compact_blocks 1) prints "data parallel over 1 device(s)", trains with
    finite losses, evaluates, writes its checkpoint and PNGs, and leaves
    no process group behind. tests/test_torch_parallel.py holds two ranks
    against JAX's mesh."""
    import json

    import numpy as np
    import torch.distributed as dist
    from test_datasets import make_dnerf_fixture
    from test_torch_train_real import FLAGS, TINY

    make_dnerf_fixture(str(tmp_path / "fx"), scene="lego", n_frames=4,
                       wh=16, ring=True)
    monkeypatch.setenv("CEDNERF_CFG", json.dumps(TINY))
    monkeypatch.chdir(tmp_path)
    s = train_real.main(["--scene", "lego", "--dp", "--device", "cpu",
                         "--data_root", str(tmp_path / "fx"),
                         "--max_steps", "16",
                         "--model_path", str(tmp_path / "ckpt")] + FLAGS)
    assert s["dp"] == 1 and s["step"] >= 16
    assert all(np.isfinite(c["loss"]) for c in s["chunks"])
    assert s["eval"]["finite"] and (tmp_path / "rgb_test.png").exists()
    assert (tmp_path / "ckpt").exists() and not dist.is_initialized()


def _jax_validator_keys():
    """The keys of the JAX tools/validate_synthetic.py's result dict."""
    import ast

    tree = ast.parse((REPO / "tools" / "validate_synthetic.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", "") == "result"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result dict in tools/validate_synthetic.py")


def test_validate_synthetic_prints_the_jax_keys(monkeypatch, tmp_path):
    """The dataset-free validator on the CPU, its ball scene shrunk to
    16x16 pixels: the JAX tool's JSON keys (plus the device, and the
    time-to-quality keys under --ttq_db), finite PSNRs, the PNGs."""
    import numpy as np

    from cednerf_torch.datasets.procedural import BallScene
    from cednerf_torch.tools import validate_synthetic as vs

    monkeypatch.setattr(vs, "BallScene", lambda n_cams, wh, n_times:
                        BallScene(n_cams=4, wh=16, n_times=4))
    args = vs.build_parser().parse_args(
        ["--steps", "16", "--mini", "--levels", "4", "--features", "4",
         "--budget", "4096", "--eval_chunk", "256", "--ttq_db", "10,40",
         "--device", "cpu", "--out", str(tmp_path)])
    res = vs.run(args)
    assert set(res) == _jax_validator_keys() | {
        "device", "ttq_s", "compile_s_estimate", "median_chunk_s"}
    assert np.isfinite([res["train_view_psnr"], res["eval_psnr"]]).all()
    for name in ("eval_rgb", "eval_gt", "train_view_rgb", "train_view_gt"):
        assert (tmp_path / f"{name}.png").exists()
    # the values that raised until they were ported take the JAX
    # validator's config (the JAX tool's own chain, re-run on the port's
    # config copy)
    for argv in (["--scene", "texture"], ["--impl", "gather"],
                 ["--grid_type", "triplane"], ["--remat_feats"],
                 ["--row_layout", "cell"], ["--row_layout", "cellz"],
                 ["--row_layout", "cellfused"]):
        a = vs.build_parser().parse_args(argv + ["--device", "cpu"])
        cfg = vs._config(a)
        assert cfg.remat_feats == a.remat_feats
        assert cfg.row_layout == (a.row_layout or "brick")


def test_validate_synthetic_texture_scene(monkeypatch, tmp_path):
    """--scene texture --row_layout cell --remat_feats at --mini on the
    CPU, the textured cloud shrunk to 16x16 pixels: the JAX tool's keys,
    finite PSNRs, the scene it asked for. (--impl gather and --grid_type
    triplane train in tests/test_torch_train.py.)"""
    import numpy as np

    from cednerf_torch.datasets.procedural import TexturedCloudScene
    from cednerf_torch.tools import validate_synthetic as vs

    monkeypatch.setattr(vs, "TexturedCloudScene",
                        lambda n_cams, wh, n_times: TexturedCloudScene(
                            n_cams=4, wh=16, n_times=4, n_balls=16))
    res = vs.run(vs.build_parser().parse_args(
        ["--steps", "16", "--mini", "--levels", "4", "--features", "4",
         "--budget", "4096", "--eval_chunk", "256", "--scene", "texture",
         "--row_layout", "cell", "--remat_feats", "--device", "cpu"]))
    assert set(res) == _jax_validator_keys() | {"device"}
    assert res["scene"] == "texture" and res["impl"] == "brick"
    assert np.isfinite([res["train_view_psnr"], res["eval_psnr"]]).all()
