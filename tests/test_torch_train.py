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
from cednerf_tpu.engine import train as jt
from cednerf_tpu.engine.cli import build_field as j_build_field
from cednerf_tpu.engine.config import ModelFlags as JFlags
from cednerf_tpu.engine.config import dnerf_config as j_dnerf_config
from cednerf_tpu.ops.occupancy import create_occ_grid as j_create_occ
from cednerf_torch.bridge import (occ_from_numpy, params_from_numpy,
                                  params_to_numpy)
from cednerf_torch.datasets.procedural import BallCloudScene, BallScene
from cednerf_torch.engine import train as tt
from cednerf_torch.engine.cli import build_field
from cednerf_torch.engine.config import ModelFlags, dnerf_config

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
    jcfg = dataclasses.replace(j_dnerf_config(), grad_accum_dtype="float32",
                               **SMALL)
    tcfg = dataclasses.replace(dnerf_config(), grad_accum_dtype="float32",
                               **SMALL)
    jfield = j_build_field(jcfg, JFlags(**flags))
    params = jax.tree_util.tree_map(np.asarray, jt.create_train_state(
        jfield, jcfg, jax.random.PRNGKey(0)).params)
    rng = np.random.default_rng(0)
    enc = params["params"]["hash_encoder"]
    for k in enc:                      # tables the MLPs feel
        enc[k] = rng.uniform(-1, 1, enc[k].shape).astype(np.float32)
    occ = j_create_occ(jcfg.aabb, jcfg.grid_resolution, 1)
    bins = rng.uniform(size=occ.binaries.shape) < 0.3
    occs = np.where(bins, 0.5, 0.0).astype(np.float32).reshape(1, -1)
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

    tfield = build_field(tcfg, ModelFlags(**flags), device="cpu")
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


@pytest.mark.parametrize("scene", ["ball", "cloud"])
def test_procedural_scenes_match_jax(scene):
    j = JBall(n_cams=4, wh=24, n_times=3, seed=5) if scene == "ball" \
        else JCloud(n_cams=4, wh=24, n_times=3, n_balls=8, seed=5)
    t = BallScene(n_cams=4, wh=24, n_times=3, seed=5) if scene == "ball" \
        else BallCloudScene(n_cams=4, wh=24, n_times=3, n_balls=8, seed=5)
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
    cfg = dataclasses.replace(dnerf_config(), **SMALL)
    flags = ModelFlags(**FLAGS)
    field = build_field(cfg, flags, device="cpu")
    scene = BallScene(n_cams=2, wh=8, n_times=2)
    with pytest.raises(NotImplementedError, match="scanned"):
        tt.Trainer(field, cfg, flags, scene, device="cpu",
                   device_sampler=object())
    with pytest.raises(NotImplementedError, match="ray-parallel"):
        tt.Trainer(field, cfg, flags, scene, device="cpu", mesh=object())
    tr = tt.Trainer(field, cfg, flags, scene, device="cpu")
    for call in (tr.run_chunk, lambda: tr.resume("x")):
        with pytest.raises(NotImplementedError, match="scanned"):
            call()
    with pytest.raises(NotImplementedError, match="scanned"):
        tt.make_train_step(field, cfg, flags, s_cap=16)
    with pytest.raises(NotImplementedError, match="scanned"):
        tt.make_train_step(field, dataclasses.replace(cfg, march_seg=8),
                           flags, use_seg=True)
