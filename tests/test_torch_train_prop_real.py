"""The proposal slice as a whole: `python -m cednerf_torch.train_prop_real`
(its main(), in process, --device cpu) on the painted on-disk D-NeRF scene
of tests/test_torch_train_real.py at its tiny CEDNERF_CFG: train -> save ->
--load_model --render_video (tests/test_train_real_cli.py's prop case);
a prop state trained by the JAX package, converted through the bridge,
rendered by the port's make_prop_eval_render_fn against JAX's (with and
without occupancy culling); the prop checkpoint's round trip with and
without an occupancy grid; the --render_video guard on a loader without a
render path (both CLIs); the prop CLI refusing --dp, as JAX's, and
PropTrainer(mesh=) on a one-rank mesh.

Tolerances: the frame as tests/test_torch_renderer.py holds the serving
path (rgb and opacity within 5e-3, depth within 2e-2 on rays of opacity
>= 1e-2): both sides' fields and proposal fields run bf16 MLPs.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_torch import train_prop_real, train_real
from cednerf_torch.engine import train_prop as tp
from cednerf_torch.engine.config import ModelFlags, dnerf_config
from test_datasets import make_hypernerf_fixture
from test_torch_train_real import (TINY, _dnerf,  # noqa: F401
                                   _one_torch_thread, _short_render_path)

# the prop path at a size the CPU trains in seconds: 64 rays a step
PROP_ARGS = ["--num_rays", "64", "-te", "-d"]


def _run(capsys, argv):
    summary = train_prop_real.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == {
        "train_prop_real": json.loads(json.dumps(summary))}
    return summary, out


def test_train_prop_real_cli(tmp_path, monkeypatch, capsys):
    """Train 16 steps (one chunk), evaluate and save; then --load_model
    --render_video loads without evaluating and writes the video frames."""
    root, box = _dnerf(str(tmp_path / "data"))
    work = tmp_path / "run"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setenv("CEDNERF_CFG", json.dumps(TINY | box))
    ckpt = str(tmp_path / "prop_ckpt")
    base = ["--data_root", root, "--scene", "lego", "--model_path",
            ckpt] + PROP_ARGS
    s, out = _run(capsys, base + ["--max_steps", "16"])
    assert "cfg overrides from CEDNERF_CFG" in out
    assert "train time:" in out and f"saved {ckpt}" in out
    assert s["step"] == 16 and s["sampler"] == "device"
    assert s["prop_config"]["n_final"] == 64
    assert np.isfinite(s["last_chunk"]["loss"])
    assert s["eval"]["finite"] and s["eval"]["n_test"] == 4
    assert "evaluation: psnr_avg=" in out
    for name in ("rgb_test.png", "depth_test.png"):
        assert (work / name).exists(), name
        os.remove(work / name)
    assert os.path.exists(os.path.join(ckpt, "state.pt"))

    _short_render_path(monkeypatch)
    r, out = _run(capsys, base + ["--load_model", "--render_video"])
    assert "loaded prop checkpoint at step 16" in out
    assert "eval" not in r and not (work / "rgb_test.png").exists()
    assert r["video"]["frames"] == 2
    for stem in ("rgb_render", "depth_render"):
        assert ((work / f"{stem}.mp4").exists()
                or (work / f"{stem}_0001.png").exists()), stem


def _small():
    """A shrunken D-NeRF config and proposal config (the prop step tests')."""
    kw = dict(target_sample_batch_size=4096, grid_resolution=16,
              hash_dst_resolution=128, log2_hashmap_size=14,
              max_table_rows=512, hash_n_levels=4, eval_chunk=256)
    pkw = dict(prop_resolutions=(64,), prop_samples=(32,), n_final=16,
               anneal_steps=8)
    return kw, pkw


def test_jax_prop_state_renders_in_port():
    """Four steps of the JAX package's prop step on BallScene batches, the
    params moved through the bridge; an eval frame of the port's
    make_prop_eval_render_fn against JAX's, with an occupancy grid (a
    random third of the cells) and without."""
    from cednerf_tpu.datasets.procedural import BallScene as JBall
    from cednerf_tpu.engine import train_prop as jtp
    from cednerf_tpu.engine.cli import build_field as j_build_field
    from cednerf_tpu.engine.config import ModelFlags as JFlags
    from cednerf_tpu.engine.config import dnerf_config as j_dnerf_config
    from cednerf_tpu.engine.renderer import render_image as j_render_image
    from cednerf_tpu.ops.occupancy import create_occ_grid as j_create_occ
    from cednerf_torch.bridge import occ_from_numpy, prop_params_from_numpy
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.renderer import render_image

    kw, pkw = _small()
    flags = dict(use_time_embedding=True, use_time_attenuation=True,
                 use_feat_predict=True, distortion_loss=True)
    jcfg = dataclasses.replace(j_dnerf_config(), **kw)
    tcfg = dataclasses.replace(dnerf_config(), **kw)
    jpcfg, tpcfg = jtp.PropConfig(**pkw), tp.PropConfig(**pkw)
    jf = j_build_field(jcfg, JFlags(**flags))
    jprops = jtp.build_prop_networks(jcfg, jpcfg)
    state = jtp.create_prop_train_state(jf, jprops, jcfg,
                                        jax.random.PRNGKey(0), jpcfg)
    step = jtp.make_prop_train_step(jf, jprops, jcfg, JFlags(**flags), jpcfg)
    scene = JBall(n_cams=4, wh=32, n_times=4)
    key = jax.random.PRNGKey(1)
    for i in range(4):
        key, k = jax.random.split(key)
        state, m = step(state, {k2: jnp.asarray(v) for k2, v in
                                scene.sample(256).items()}, k, i)
        assert np.isfinite(float(m["loss"]))
    params = jax.tree_util.tree_map(np.asarray, state.params)

    field = build_field(tcfg, ModelFlags(**flags), device="cpu")
    props = tp.build_prop_networks(tcfg, tpcfg, device="cpu")
    fsd, psds = prop_params_from_numpy(params)
    field.load_state_dict(fsd, strict=True)
    for p, sd in zip(props, psds):
        p.load_state_dict(sd, strict=True)

    rng = np.random.default_rng(0)
    jocc = j_create_occ(jcfg.aabb, jcfg.grid_resolution, jcfg.grid_nlvl)
    bins = rng.uniform(size=jocc.binaries.shape) < 0.3
    occs = np.where(bins, 0.5, 0.0).astype(np.float32).reshape(1, -1)
    jocc = jocc._replace(occs=jnp.asarray(occs), binaries=jnp.asarray(bins))
    tocc = occ_from_numpy(occs, bins, np.asarray(jocc.aabbs), device="cpu")

    t = float(scene.times[1])
    view = scene.image_rays(0, t)
    bkgd = np.ones(3, np.float32)
    jfn = jtp.make_prop_eval_render_fn(jf, jprops, jcfg, jpcfg)
    tfn = tp.make_prop_eval_render_fn(field, props, tcfg, tpcfg)
    for jo, to in ((jocc, tocc), (None, None)):
        want = [np.asarray(a) for a in j_render_image(
            jf, params, jo, jfn, view["origins"], view["viewdirs"],
            jnp.float32(t), jnp.asarray(bkgd), chunk=256)]
        got = render_image(field, to, tfn, view["origins"],
                           view["viewdirs"], t, bkgd, chunk=256)
        assert 0.05 < want[1].mean() < 0.95, want[1].mean()
        seen = want[1][..., 0] >= 1e-2
        for name, g, w, tol in (("rgb", got[0], want[0], 5e-3),
                                ("opacity", got[1], want[1], 5e-3),
                                ("depth", got[2][seen], want[2][seen], 2e-2)):
            assert g.shape == w.shape and np.isfinite(g).all()
            np.testing.assert_allclose(g, w, atol=tol,
                                       err_msg=f"{name} occ={to is not None}")


def _prop_state(pcfg_kw=None):
    kw, pkw = _small()
    cfg = dataclasses.replace(dnerf_config(), **kw)
    pcfg = tp.PropConfig(**(pcfg_kw or pkw))
    from cednerf_torch.engine.cli import build_field

    field = build_field(cfg, ModelFlags(use_time_embedding=True),
                        device="cpu")
    props = tp.build_prop_networks(cfg, pcfg, device="cpu")
    return cfg, pcfg, tp.create_prop_train_state(field, props, cfg, pcfg,
                                                 device="cpu")


def test_prop_checkpoint_round_trip(tmp_path):
    """With an occupancy grid stored, the load returns it (on the template's
    device); without one, None (not the template); the field, the proposal
    fields and the optimizer's state come back; another proposal config
    raises naming the tensors."""
    from cednerf_torch.engine.checkpoint import (load_prop_checkpoint,
                                                 save_prop_checkpoint)
    from cednerf_torch.ops.occupancy import create_occ_grid

    cfg, pcfg, state = _prop_state()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in state.optimizer.params:
            p.add_(torch.randn(p.shape, generator=gen))
            p.grad = torch.randn(p.shape, generator=gen)
    state.optimizer.step()
    occ = create_occ_grid(cfg.aabb, 16, 1, device="cpu")
    occ = occ._replace(binaries=torch.rand(occ.binaries.shape,
                                           generator=gen) < 0.3)
    rng = torch.Generator().manual_seed(0).get_state()
    save_prop_checkpoint(str(tmp_path / "with"), state, occ, 48, rng)
    save_prop_checkpoint(str(tmp_path / "without"), state, None, 32)

    template = create_occ_grid(cfg.aabb, 16, 1, device="cpu")
    for name, want_occ, want_step in (("with", occ, 48),
                                      ("without", None, 32)):
        _, _, fresh = _prop_state()
        got, got_occ, step, got_rng = load_prop_checkpoint(
            str(tmp_path / name), fresh, template)
        assert step == want_step
        assert (got_rng is None) == (name == "without")
        if want_occ is None:
            assert got_occ is None
        else:
            for a, b in zip(got_occ, want_occ):
                assert torch.equal(a, b)
        for a, b in zip(got.optimizer.params, state.optimizer.params):
            assert torch.equal(a, b)
        sd_a, sd_b = (got.optimizer.state_dict(),
                      state.optimizer.state_dict())
        for a, b in zip(sd_a["mu"] + sd_a["nu"], sd_b["mu"] + sd_b["nu"]):
            assert torch.equal(a, b)
        assert got.optimizer.count.item() == 1
    _, _, fresh = _prop_state()
    assert load_prop_checkpoint(str(tmp_path / "with"), fresh, None)[1] \
        is None

    _, _, other = _prop_state(dict(prop_resolutions=(64, 128),
                                   prop_samples=(32, 16), n_final=16))
    with pytest.raises(ValueError, match="props.1.grid.grid_0"):
        load_prop_checkpoint(str(tmp_path / "with"), other, template)


@pytest.mark.parametrize("cli", [train_real, train_prop_real])
def test_render_video_needs_a_render_path(cli, tmp_path):
    """HyperNeRF's loader has no render path: --render_video stops before
    any training with a message naming the loader and the flag."""
    root = make_hypernerf_fixture(str(tmp_path / "data"),
                                  scene="vrig_chicken", n_imgs=6, wh=16)
    ckpt = tmp_path / "ckpt"
    with pytest.raises(SystemExit, match="--render_video: the "
                       "HyperNeRFDataset loader of --scene vrig_chicken"):
        cli.main(["--data_root", root, "--scene", "vrig_chicken",
                  "--render_video", "--model_path", str(ckpt),
                  "--device", "cpu"])
    assert not ckpt.exists()


def test_unported_prop_paths_raise(capsys):
    """Both raised until the ray-parallel slice of the port. Now the prop
    CLI rejects --dp as an unknown flag, as the JAX train_prop_real.py
    does (it has none: data parallelism on the proposal path is
    PropTrainer(mesh=...)), and PropTrainer(mesh=...) runs: a chunk on a
    one-rank gloo mesh with finite metrics (tests/test_torch_parallel.py
    holds two ranks against one process)."""
    import torch.distributed as dist
    from cednerf_torch.datasets.procedural import BallScene
    from cednerf_torch.parallel import make_mesh

    with pytest.raises(SystemExit):
        train_prop_real.main(["--scene", "lego", "--dp", "--device", "cpu"])
    assert "unrecognized arguments: --dp" in capsys.readouterr().err
    cfg, pcfg, state = _prop_state()
    made = not dist.is_initialized()
    try:
        tr = tp.PropTrainer(
            state.field, state.props, cfg, ModelFlags(), pcfg,
            BallScene(n_cams=2, wh=8, n_times=2).device_sampler("cpu"),
            n_rays=64, steps_per_call=2, mesh=make_mesh(device="cpu"),
            device="cpu")
        m = tr.run_chunk()
        assert tr.step == 2 and np.isfinite(m["loss"]) and m["psnr"] > 0
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
