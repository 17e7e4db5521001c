"""The port's train engine against the JAX package's.

  * the LR schedule, and Adam(eps=1e-15) + LambdaLR against optax's
    adam(learning_rate=schedule, eps=1e-15) on injected gradients;
  * one train step from the same bridged weights, occupancy grid, ray
    batch and march jitter: loss, mse, n_valid, complete_frac and every
    parameter's gradient (not the post-step parameters: Adam's first step
    moves a parameter by ~lr * sign(g) for any nonzero g, so bf16 noise in a
    near-zero gradient flips its update);
  * the procedural scenes give the JAX package's batches, and a short CPU
    Trainer run raises its PSNR; entry points refuse a missing card.

Tolerances. Schedule rtol 1e-6 (JAX computes it in f32). Adam on equal
f32 gradients: rtol 1e-5, atol 1e-8 on the parameters (f32 rounding of the
same update formula). Train step: n_valid and complete_frac exact (JAX
jitted and the port march the same lattice to the same bits here); loss and
mse rtol 1e-3; each parameter's gradient within 8% of its L2 norm (observed
up to 3.8%: JAX forms the encoder's lane weights and products in bf16, the
port in f32, and the bf16 MLP GEMMs round differently in XLA and PyTorch;
the motion MLP, whose gradient arrives through d_x, is the most sensitive).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cednerf_tpu.datasets.procedural import BallCloudScene as JCloud
from cednerf_tpu.datasets.procedural import BallScene as JBall
from cednerf_tpu.datasets.procedural import MonocularOrbitScene as JMono
from cednerf_tpu.engine import train as jt
from cednerf_tpu.engine.cli import build_field as j_build_field
from cednerf_tpu.engine.config import ModelFlags as JFlags
from cednerf_tpu.engine.config import dnerf_config as j_dnerf_config
from cednerf_tpu.engine.config import hypernerf_config as j_hyper_config
from cednerf_tpu.ops.occupancy import create_occ_grid as j_create_occ
from cednerf_torch.bridge import (occ_from_numpy, params_from_numpy,
                                  params_to_numpy)
from cednerf_torch.datasets.procedural import (BallCloudScene, BallScene,
                                               MonocularOrbitScene)
from cednerf_torch.engine import train as tt
from cednerf_torch.engine.cli import build_field
from cednerf_torch.engine.config import (ModelFlags, dnerf_config,
                                         hypernerf_config)

FLAGS = dict(use_div_offsets=True, use_feat_predict=True,
             use_time_embedding=True, use_time_attenuation=True,
             distortion_loss=True, acc_entropy_loss=True)
SMALL = dict(target_sample_batch_size=4096, grid_resolution=16,
             render_step_size=2e-2, max_march_steps=128,
             hash_dst_resolution=128, log2_hashmap_size=14,
             max_table_rows=512, hash_n_levels=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The CPU train steps are hundreds of small ops: with torch's default of
    one OpenMP thread per core in each of the suite's worker processes the
    threads oversubscribe the cores and a 5 s run takes minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_lr_schedule_matches_jax():
    for max_steps in (8, 20000):
        jcfg, tcfg = j_dnerf_config(max_steps), dnerf_config(max_steps)
        js, ts = jt.make_lr_schedule(jcfg), tt.make_lr_schedule(tcfg)
        for c in list(range(0, 130, 7)) + [max_steps // 2, max_steps - 1,
                                           max_steps * 9 // 10]:
            np.testing.assert_allclose(ts(c), float(js(c)), rtol=1e-6)


def test_adam_and_schedule_match_optax():
    cfg = dnerf_config(max_steps=8)          # milestones 4, 6, 7
    rng = np.random.default_rng(0)
    shapes = {"a": (33,), "b": (4, 5)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in
          shapes.items()}
    tx = jt.make_optimizer(j_dnerf_config(max_steps=8))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt, sched = tt.make_optimizer(list(tp.values()), cfg)
    for step in range(8):
        grads = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-6, 1, s))
                 .astype(np.float32) for k, s in shapes.items()}
        grads["a"][:3] = 0.0
        upd, js = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                            js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        sched.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-8, err_msg=f"{k} {step}")


def _grad_capture():
    """An optax transformation that applies nothing and keeps the step's
    gradients in its state."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(
        lambda p: {"g": zeros(p)}, lambda g, s, p=None: (zeros(g), {"g": g}))


@pytest.mark.parametrize("grid_type", ["hash3d", "hash4d"])
def test_one_train_step_matches_jax(grid_type):
    """hash4d: the 4D keyframe encoder (K = 4), whose backward reaches K3's
    plain version here; the JAX step keeps its default scatter_impl "xla"
    (the same sums: test_torch_keyframe_encoder.py holds K3 against the
    JAX Pallas kernel)."""
    flags = {**FLAGS, "grid_type": grid_type}
    kw = dict(grad_accum_dtype="float32", **SMALL)
    _step_parity(dataclasses.replace(j_dnerf_config(), **kw),
                 dataclasses.replace(dnerf_config(), **kw), flags)


STEP_OPTIONS = {
    "cell": (dict(row_layout="cell"), {}, "brick"),
    "cellz_remat": (dict(row_layout="cellz", remat_feats=True), {}, "brick"),
    "hash4d_cell": (dict(row_layout="cell"), dict(grid_type="hash4d"),
                    "brick"),
    "hash4motion": ({}, dict(hash4motion=True), "brick"),
    "triplane": ({}, dict(grid_type="triplane"), "brick"),
    "gather": ({}, {}, "gather"),
    "hash4d_gather": ({}, dict(grid_type="hash4d"), "gather"),
}


@pytest.mark.parametrize("case", list(STEP_OPTIONS))
def test_train_step_options_match_jax(case):
    """One train step with each secondary encoder or option against the
    JAX step (f32 table-gradient accumulation, _step_parity's limits); the
    cell layouts' backward reaches K6c's plain version (3D) or K3's (4D)."""
    cfg_kw, flag_kw, impl = STEP_OPTIONS[case]
    kw = dict(grad_accum_dtype="float32", **SMALL, **cfg_kw)
    _step_parity(dataclasses.replace(j_dnerf_config(), **kw),
                 dataclasses.replace(dnerf_config(), **kw),
                 {**FLAGS, **flag_kw}, encoder_impl=impl)


# the shrunken HyperNeRF preset: SMALL's field and budget with the preset's
# cone_angle 4e-3, 2 grid levels, alpha_thre 1e-2 and near plane 0.2; a
# 1e-2 step (the preset's 1e-3 would need ~1024 lattice steps to cross the
# +-2 box) and 256 steps
HYPER_SMALL = dict(SMALL, render_step_size=1e-2, max_march_steps=256)


@pytest.mark.parametrize("case", ["dense", "hypernerf", "hypernerf_dense"])
def test_unpacked_and_hypernerf_steps_match_jax(case):
    """The dense-lattice step (packed_render=False: render_rays_budget, the
    unpacked distortion loss) on the D-NeRF config, and a step of the
    shrunken HyperNeRF preset (packed and dense), against JAX's at the
    limits of test_one_train_step_matches_jax. The density head's bias is
    raised so that most samples pass the preset's alpha_thre."""
    kw = dict(grad_accum_dtype="float32",
              packed_render=not case.endswith("dense"))
    if case.startswith("hypernerf"):
        jcfg = dataclasses.replace(j_hyper_config("vrig_3dprinter"),
                                   **HYPER_SMALL, **kw)
        tcfg = dataclasses.replace(hypernerf_config("vrig_3dprinter"),
                                   **HYPER_SMALL, **kw)
        assert (tcfg.cone_angle, tcfg.grid_nlvl, tcfg.alpha_thre,
                tcfg.near_plane) == (4e-3, 2, 1e-2, 0.2)
        _step_parity(jcfg, tcfg, FLAGS, density_bias=2.0, p_occ=0.15)
    else:
        _step_parity(dataclasses.replace(j_dnerf_config(), **SMALL, **kw),
                     dataclasses.replace(dnerf_config(), **SMALL, **kw),
                     FLAGS)


def _step_parity(jcfg, tcfg, flags, density_bias=None, p_occ=0.3,
                 encoder_impl="brick"):
    """One train step of jcfg (JAX) and tcfg (port) from the same weights
    (tables uniform(-1, 1)), occupancy grid (p_occ of the cells of each
    level; the HyperNeRF lattice's 2 levels hold about twice the demand),
    ray batch and march jitter: n_valid and complete_frac exact, loss and
    mse rtol 1e-3, each gradient within 8% of its L2 norm."""
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jfield = j_build_field(jcfg, JFlags(**flags)).clone(
        encoder_impl=encoder_impl)
    params = jax.tree_util.tree_map(np.array, jt.create_train_state(
        jfield, jcfg, jax.random.PRNGKey(0)).params)
    rng = np.random.default_rng(0)
    enc = params["params"]["hash_encoder"]
    for k in enc:                      # tables the MLPs feel
        enc[k] = rng.uniform(-1, 1, enc[k].shape).astype(np.float32)
    if density_bias is not None:
        params["params"]["mlp_base"]["out"]["bias"][0] = density_bias
    occ = j_create_occ(jcfg.aabb, jcfg.grid_resolution, jcfg.grid_nlvl)
    bins = rng.uniform(size=occ.binaries.shape) < p_occ
    occs = np.where(bins, 0.5, 0.0).astype(np.float32).reshape(
        jcfg.grid_nlvl, -1)
    occ = occ._replace(occs=jnp.asarray(occs), binaries=jnp.asarray(bins))
    batch = JBall(n_cams=4, wh=32, n_times=4).sample(128)
    key = jax.random.PRNGKey(3)
    k_march, = jax.random.split(key, 1)          # as the JAX step splits
    jitter = np.asarray(jax.random.uniform(k_march, (128,)))

    cap = _grad_capture()
    one = jt._make_one_step(jfield, jcfg, JFlags(**flags), 4096, cap)
    jstate = jt.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt_state=cap.init(params), occ=occ)
    out, jm = jax.jit(one)(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, key)
    jgrads = jax.tree_util.tree_map(np.asarray, out.opt_state["g"])

    tfield = build_field(tcfg, ModelFlags(**flags), device="cpu",
                         encoder_impl=encoder_impl)
    tfield.load_state_dict(params_from_numpy(params), strict=True)
    state = tt.create_train_state(tfield, tcfg, device="cpu")
    state.occ = occ_from_numpy(occs, bins, np.asarray(occ.aabbs),
                               device="cpu")
    loss_and_grads = tt._make_loss_fn(tcfg, ModelFlags(**flags), 4096)
    loss, aux = loss_and_grads(
        state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        jitter=torch.from_numpy(jitter))

    assert aux["n_valid"].item() == float(jm["n_valid"])
    assert aux["complete_frac"].item() == float(jm["complete_frac"])
    assert 0.5 < float(jm["complete_frac"]) < 1.0
    np.testing.assert_allclose(loss.item(), float(jm["loss"]), rtol=1e-3)
    np.testing.assert_allclose(aux["mse"].item(), float(jm["mse"]),
                               rtol=1e-3)
    tgrads = params_to_numpy({n: p.grad for n, p in
                              tfield.named_parameters()})
    want = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(tgrads)[0])
    assert want.keys() == got.keys()
    for k in want:
        w, g = want[k], got[k]
        assert np.linalg.norm(w) > 0, jax.tree_util.keystr(k)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < 0.08, (jax.tree_util.keystr(k), rel)


@pytest.mark.parametrize("scene", ["ball", "cloud", "mono"])
def test_procedural_scenes_match_jax(scene):
    if scene == "ball":
        j = JBall(n_cams=4, wh=24, n_times=3, seed=5)
        t = BallScene(n_cams=4, wh=24, n_times=3, seed=5)
    elif scene == "cloud":
        j = JCloud(n_cams=4, wh=24, n_times=3, n_balls=8, seed=5)
        t = BallCloudScene(n_cams=4, wh=24, n_times=3, n_balls=8, seed=5)
    else:
        j = JMono(n_frames=4, wh=24, n_balls=8, seed=5)
        t = MonocularOrbitScene(n_frames=4, wh=24, n_balls=8, seed=5)
        np.testing.assert_array_equal(t.vels, j.vels)
    np.testing.assert_array_equal(t.timestamps_pool, j.timestamps_pool)
    for _ in range(2):
        bj, bt = j.sample(300), t.sample(300)
        assert bj.keys() == bt.keys()
        for k in bj:
            np.testing.assert_array_equal(bt[k], np.asarray(bj[k]),
                                          err_msg=k)
    for a, b in zip(t.eval_view(0.3, 0.5), j.eval_view(0.3, 0.5)):
        np.testing.assert_array_equal(a, b)
    it, ij = t.image_rays(1, 0.25), j.image_rays(1, 0.25)
    for k in ("origins", "viewdirs", "pixels"):
        np.testing.assert_array_equal(it[k], ij[k], err_msg=k)


def test_monocular_orbit_scene_entangles_cam_and_time():
    """MonocularOrbitScene (JAX tests/test_datasets.py:629): every sampled
    ray's camera is its time's camera, on the host and the device sampler,
    and the device sampler's ground truth is the host's analytic render of
    the same rays; a multi-view scene keeps (camera, time) independent."""
    scene = MonocularOrbitScene(n_frames=8, wh=32, n_balls=8)
    assert scene.monocular and len(scene.c2ws) == len(scene.times)

    def time_index(batch):
        t = np.asarray(batch["timestamps"]).reshape(-1)
        return np.argmin(np.abs(t[:, None] - scene.times[None]), axis=1)

    batch = scene.sample(128)
    np.testing.assert_allclose(batch["origins"],
                               scene.c2ws[time_index(batch)][:, :, 3],
                               atol=1e-5)
    data, fn = scene.device_sampler(device="cpu")
    db = {k: v.numpy() for k, v in
          fn(data, torch.Generator().manual_seed(3), 128).items()}
    ti = time_index(db)
    np.testing.assert_allclose(db["origins"], scene.c2ws[ti][:, :, 3],
                               atol=1e-5)
    gt = np.empty_like(db["pixels"])
    for k in np.unique(ti):
        m = ti == k
        gt[m] = scene._render_gt(db["origins"][m], db["viewdirs"][m],
                                 scene.times[k])
    np.testing.assert_allclose(db["pixels"], gt, atol=1e-6)
    assert 0.1 < (gt == 1.0).all(-1).mean() < 0.9      # hits and misses
    mv = BallCloudScene(n_cams=8, wh=32, n_times=8, n_balls=8)
    b2 = mv.sample(256)
    t2 = b2["timestamps"].reshape(-1)
    ti2 = np.argmin(np.abs(t2[:, None] - mv.times[None]), axis=1)
    assert not np.allclose(b2["origins"], mv.c2ws[ti2][:, :, 3])


def test_trainer_cpu_run_raises_psnr():
    cfg = dataclasses.replace(dnerf_config(max_steps=64), occ_warmup_steps=8,
                              occ_update_interval=4, **SMALL)
    flags = ModelFlags(**FLAGS)
    field = build_field(cfg, flags, device="cpu")
    tr = tt.Trainer(field, cfg, flags, BallScene(n_cams=4, wh=32, n_times=4),
                    seed=0, device="cpu")
    psnr = []
    for _ in range(64):
        m = tr.run_step()
        assert np.isfinite(m["loss"])
        psnr.append(m["psnr"])
    assert tr.step == 64 and m["num_rays"] in cfg.ray_buckets()
    assert np.mean(psnr[-8:]) > np.mean(psnr[:8]) + 1.0, psnr


def test_train_entry_points_refuse_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(dnerf_config(), **SMALL)
    flags = ModelFlags(**FLAGS)
    field = build_field(cfg, flags, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.create_train_state(field, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Trainer(field, cfg, flags, BallScene(n_cams=2, wh=8, n_times=2))


def test_later_slices_raise():
    """What raised here until its slice of the port now runs: the device
    mesh (Trainer(mesh=...) on a one-rank gloo mesh takes finite steps;
    tests/test_torch_parallel.py holds two ranks against JAX's mesh and the
    one-process run) and the dense-lattice renderer (packed_render=False:
    a Trainer step returns finite metrics,
    test_unpacked_and_hypernerf_steps_match_jax holds it against JAX). The
    scanned path (device samplers, run_chunk, resume, s_cap, use_seg,
    empty-space skipping) runs since its slice: test_torch_train_loop.py,
    test_torch_steady_march.py."""
    import torch.distributed as dist
    from cednerf_torch.parallel import make_mesh

    cfg = dataclasses.replace(dnerf_config(), **SMALL)
    flags = ModelFlags(**FLAGS)
    scene = BallScene(n_cams=2, wh=8, n_times=2)
    made = not dist.is_initialized()
    try:
        mesh = make_mesh(device="cpu")
        tr = tt.Trainer(build_field(cfg, flags, device="cpu"), cfg, flags,
                        scene, seed=0, device="cpu", mesh=mesh)
        m = tr.run_step()
        assert all(np.isfinite(v) for v in m.values()), m
        assert m["n_samples"] > 0 and tr.mesh.size == 1
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    dense = dataclasses.replace(cfg, packed_render=False,
                                occ_warmup_steps=2, occ_update_interval=2)
    tr = tt.Trainer(build_field(dense, flags, device="cpu"), dense, flags,
                    scene, seed=0, device="cpu")
    for _ in range(3):
        m = tr.run_step()
        assert all(np.isfinite(v) for v in m.values()), m
    assert m["n_samples"] > 0 and tr.step == 3
