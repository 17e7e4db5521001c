"""The port's steady-state march and step against the JAX package's.

  * empty-space skipping (advance_t_min, march_candidates(probe_steps)),
    per-ray candidate packing (pack_candidates) and two-stage segment
    marching (march_segments) on numpy-made grids, rays and march jitter;
  * one steady-state train step (skip lattice, s_cap, march_seg) from the
    same bridged weights, grid, batch and jitter as the JAX step;
  * the procedural scenes' device samplers: sample_at on numpy draws.

Tolerances. Integer and boolean outputs are exact: valid, covered, the
packed lattice, ray/starts/counts/complete/n_valid and span_slots. Float
positions and t values within 1e-6 relative (the JAX functions run jitted
on the CPU, where XLA may contract t_min + first * seg_len and the segment
midpoints into FMAs that the port's eager ops round twice). A steady
step's loss and gradients within the limits of test_torch_train.py's
test_one_train_step_matches_jax: loss and mse rtol 1e-3, each parameter's
gradient within 8% of its L2 norm (bf16 products in JAX's encoder and
MLPs). Device-sampler rays and pixels atol 1e-5 (f32 ops in another
order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.datasets.procedural import BallCloudScene as JCloud
from cednerf_tpu.datasets.procedural import BallScene as JBall
from cednerf_tpu.engine import renderer as jr
from cednerf_tpu.engine import train as jt
from cednerf_tpu.engine.cli import build_field as j_build_field
from cednerf_tpu.engine.config import ModelFlags as JFlags
from cednerf_tpu.engine.config import dnerf_config as j_dnerf_config
from cednerf_tpu.engine.sampling import pinhole_rays_device as j_pinhole
from cednerf_tpu.ops import occupancy as jo
from cednerf_torch.bridge import (occ_from_numpy, params_from_numpy,
                                  params_to_numpy)
from cednerf_torch.datasets.procedural import BallCloudScene, BallScene
from cednerf_torch.engine import renderer as tr
from cednerf_torch.engine import train as tt
from cednerf_torch.engine.cli import build_field
from cednerf_torch.engine.config import ModelFlags, dnerf_config
from cednerf_torch.ops import occupancy as to

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
MARCH = dict(near_plane=0.0, far_plane=1e10, render_step_size=2e-2,
             cone_angle=0.0)
FLAGS = dict(use_div_offsets=True, use_feat_predict=True,
             use_time_embedding=True, use_time_attenuation=True,
             distortion_loss=True, acc_entropy_loss=True)
SMALL = dict(target_sample_batch_size=4096, grid_resolution=16,
             render_step_size=2e-2, max_march_steps=128,
             hash_dst_resolution=128, log2_hashmap_size=14,
             max_table_rows=512, hash_n_levels=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The CPU steps are hundreds of small ops: one OpenMP thread per core
    in each of the suite's worker processes would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _grids(seed, res=32, frac=0.03):
    """The same random single-level grid for both packages."""
    rng = np.random.default_rng(seed)
    bins = rng.uniform(size=(1, res, res, res)) < frac
    occs = np.where(bins, 0.5, 0.0).astype(np.float32).reshape(1, -1)
    occ_j = jo.create_occ_grid(AABB, res, 1)
    aabbs = np.asarray(occ_j.aabbs)
    occ_j = occ_j._replace(occs=jnp.asarray(occs), binaries=jnp.asarray(bins))
    return occ_j, occ_from_numpy(occs, bins, aabbs, device="cpu")


def _rays(seed, n=256):
    rng = np.random.default_rng(seed + 100)
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _shell_bins(res, rng, radius=0.55, width=0.2, noise=0.0):
    """[1, res, res, res] bool: the cells of a shell about the centre (a
    carved grid, as training leaves it) plus `noise` random cells."""
    c = (np.arange(res) + 0.5) / res * 3.0 - 1.5
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                + c[None, None, :] ** 2)
    return ((np.abs(r - radius) < width)
            | (rng.uniform(size=r.shape) < noise))[None]


def _camera_rays(seed, n=256):
    """Rays from a 3-unit sphere towards the centre, spread so that some
    miss the shell, some graze it and some cross it."""
    rng = np.random.default_rng(seed + 200)
    o = rng.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 3.0 + 0.35 * rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _jitter(key, n):
    """The JAX march's jitter draw for `key`, fed to the port as numbers."""
    return np.asarray(jax.random.uniform(key, (n,)))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("march_steps,probe_steps",
                         [(64, 256), (128, 256), (96, 200)])
def test_advance_t_min_and_probe_march_match_jax(march_steps, probe_steps):
    rng = np.random.default_rng(march_steps)
    bins = _shell_bins(32, rng, noise=0.002)
    occs = np.where(bins, 0.5, 0.0).astype(np.float32).reshape(1, -1)
    occ_j = jo.create_occ_grid(AABB, 32, 1)
    occ_t = occ_from_numpy(occs, bins, np.asarray(occ_j.aabbs), device="cpu")
    occ_j = occ_j._replace(occs=jnp.asarray(occs), binaries=jnp.asarray(bins))
    o, d = _camera_rays(march_steps)
    key = jax.random.PRNGKey(march_steps)
    u = _jitter(key, o.shape[0])
    to_t = lambda a: torch.tensor(a)  # noqa: E731

    cand_j = jax.jit(lambda occ, o, d: jo.march_candidates(
        occ, o, d, max_march_steps=march_steps, stratified_key=key,
        probe_steps=probe_steps, **MARCH))(occ_j, o, d)
    cand_t = to.march_candidates(occ_t, to_t(o), to_t(d),
                                 max_march_steps=march_steps,
                                 jitter=to_t(u), probe_steps=probe_steps,
                                 **MARCH)
    cov = np.asarray(cand_j.covered)
    assert 0 < cov.sum() < cov.size, "covered must be mixed to be a test"
    np.testing.assert_array_equal(_np(cand_t.covered), cov)
    np.testing.assert_array_equal(_np(cand_t.valid), np.asarray(cand_j.valid))
    assert np.asarray(cand_j.valid).sum() > 100
    np.testing.assert_allclose(_np(cand_t.t_starts),
                               np.asarray(cand_j.t_starts), rtol=1e-6)

    # advance_t_min alone, on raw slab intervals jittered by the same u
    t0, t1 = jo.ray_aabb_intersect(o, d, occ_j.aabbs[-1])
    t0 = np.asarray(t0) + u * MARCH["render_step_size"]
    t1 = np.asarray(t1)
    adv_j, cov_j = jax.jit(lambda occ, o, d, a, b: jo.advance_t_min(
        occ, o, d, a, b, render_step_size=MARCH["render_step_size"],
        march_steps=march_steps, probe_steps=probe_steps))(
            occ_j, o, d, t0, t1)
    adv_t, cov_t = to.advance_t_min(
        occ_t, to_t(o), to_t(d), to_t(t0), to_t(t1),
        render_step_size=MARCH["render_step_size"], march_steps=march_steps,
        probe_steps=probe_steps)
    np.testing.assert_array_equal(_np(cov_t), np.asarray(cov_j))
    np.testing.assert_allclose(_np(adv_t), np.asarray(adv_j), rtol=1e-6)


@pytest.mark.parametrize("s_cap", [4, 12, 300])
def test_pack_candidates_matches_jax(s_cap):
    occ_j, occ_t = _grids(7, frac=0.05)
    o, d = _rays(7)
    key = jax.random.PRNGKey(7)
    u = _jitter(key, o.shape[0])
    cand_j = jo.march_candidates(occ_j, o, d, max_march_steps=256,
                                 stratified_key=key, **MARCH)
    cand_t = to.march_candidates(occ_t, torch.from_numpy(o),
                                 torch.from_numpy(d), max_march_steps=256,
                                 jitter=torch.tensor(u), **MARCH)
    np.testing.assert_array_equal(_np(cand_t.valid), np.asarray(cand_j.valid))
    # the packed lattice of both from the same candidates (JAX's own
    # t values), so the check is of the packing alone
    cand_t = cand_t._replace(t_starts=torch.tensor(
        np.asarray(cand_j.t_starts)), dts=torch.tensor(
            np.asarray(cand_j.dts)))
    pj, fj = jr.pack_candidates(cand_j, s_cap)
    pt, ft = tr.pack_candidates(cand_t, s_cap)
    fits = np.asarray(fj)
    if s_cap < 256:
        assert 0 < fits.sum() < fits.size
    np.testing.assert_array_equal(_np(ft), fits)
    for f in ("t_starts", "dts", "valid"):
        np.testing.assert_array_equal(_np(getattr(pt, f)),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    assert pt.covered is None and pj.covered is None


SEG_CASES = {
    # ample budget and overcommit: nothing dropped
    "ample": dict(frac=0.05, budget=16384, overcommit=4.0),
    # a dense grid: both stages overflow, rays incomplete
    "overflow": dict(frac=0.5, budget=2048, overcommit=1.2),
}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_march_segments_matches_jax(case):
    c = SEG_CASES[case]
    occ_j, occ_t = _grids(11, frac=c["frac"])
    o, d = _rays(11)
    ts = np.full((o.shape[0], 1), 0.5, np.float32)
    key = jax.random.PRNGKey(11)
    u = _jitter(key, o.shape[0])
    kw = dict(budget=c["budget"], seg=8, overcommit=c["overcommit"], pool=4,
              max_march_steps=256, **MARCH)
    pj = jax.jit(lambda occ, o, d, ts: jr.march_segments(
        occ, o, d, ts, stratified_key=key, **kw))(occ_j, o, d, ts)
    pt = tr.march_segments(occ_t, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(ts), jitter=torch.from_numpy(u),
                           **kw)
    for f in ("ray", "starts", "counts", "valid", "complete", "n_valid"):
        np.testing.assert_array_equal(_np(getattr(pt, f)),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    for f in ("pos", "dirs", "ts", "t_starts", "dts"):
        np.testing.assert_allclose(_np(getattr(pt, f)),
                                   np.asarray(getattr(pj, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    complete = _np(pt.complete)
    if case == "overflow":
        assert not complete.all()
        assert int(pt.n_valid) > int(pt.valid.sum())
    else:
        assert complete.all() and int(pt.n_valid) == int(pt.valid.sum())


def _grad_capture():
    """An optax transformation that applies nothing and keeps the step's
    gradients in its state."""
    import optax
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(
        lambda p: {"g": zeros(p)}, lambda g, s, p=None: (zeros(g), {"g": g}))


STEADY = {
    # empty-space skipping: a 112-slot lattice from each ray's first
    # occupied segment, probing the 256-slot traversal (a 64^3 grid, so
    # that the probe's pooled, dilated cells leave some spans short)
    "skip": (dict(steady_march_steps=112, max_march_steps=256,
                  grid_resolution=64), dict(steady_march=True)),
    # per-ray candidate cap
    "s_cap": (dict(), dict(s_cap=24)),
    # two-stage segment marching (K4 twice on the card)
    "seg": (dict(march_seg=8, seg_overcommit=2.0), dict(use_seg=True)),
}


@pytest.mark.parametrize("branch", sorted(STEADY))
def test_steady_step_matches_jax(branch):
    cfg_kw, step_kw = STEADY[branch]
    jcfg = dataclasses.replace(j_dnerf_config(), grad_accum_dtype="float32",
                               **{**SMALL, **cfg_kw})
    tcfg = dataclasses.replace(dnerf_config(), grad_accum_dtype="float32",
                               **{**SMALL, **cfg_kw})
    jfield = j_build_field(jcfg, JFlags(**FLAGS))
    params = jax.tree_util.tree_map(np.asarray, jt.create_train_state(
        jfield, jcfg, jax.random.PRNGKey(0)).params)
    rng = np.random.default_rng(1)
    enc = params["params"]["hash_encoder"]
    for k in enc:                      # tables the MLPs feel
        enc[k] = rng.uniform(-1, 1, enc[k].shape).astype(np.float32)
    # a carved grid: a shell of cells plus 1% noise, so that spans, caps
    # and segments bind on some rays and not on others
    res = jcfg.grid_resolution
    bins = _shell_bins(res, rng, noise=0.01)
    occs = np.where(bins, 0.5, 0.0).astype(np.float32).reshape(1, -1)
    occ = jo.create_occ_grid(jcfg.aabb, res, 1)
    aabbs = np.asarray(occ.aabbs)
    occ = occ._replace(occs=jnp.asarray(occs), binaries=jnp.asarray(bins))
    batch = JBall(n_cams=4, wh=32, n_times=4).sample(128)
    key = jax.random.PRNGKey(3)
    k_march, = jax.random.split(key, 1)          # as the JAX step splits
    jitter = _jitter(k_march, 128)

    cap = _grad_capture()
    one = jt._make_one_step(jfield, jcfg, JFlags(**FLAGS), 4096, cap,
                            **step_kw)
    jstate = jt.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt_state=cap.init(params), occ=occ)
    out, jm = jax.jit(one)(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, key)
    jgrads = jax.tree_util.tree_map(np.asarray, out.opt_state["g"])

    tfield = build_field(tcfg, ModelFlags(**FLAGS), device="cpu")
    tfield.load_state_dict(params_from_numpy(params), strict=True)
    state = tt.create_train_state(tfield, tcfg, device="cpu")
    state.occ = occ_from_numpy(occs, bins, aabbs, device="cpu")
    loss, aux = tt._make_loss_fn(tcfg, ModelFlags(**FLAGS), 4096, **step_kw)(
        state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        jitter=torch.tensor(jitter))

    for k in ("n_valid", "complete_frac", "span_slots"):
        assert aux[k].item() == float(jm[k]), (k, aux[k], jm[k])
    assert 0.2 < float(jm["complete_frac"]) < 1.0, jm["complete_frac"]
    if branch != "seg":
        assert float(jm["span_slots"]) > 0
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
def test_device_sampler_matches_jax(scene):
    """sample_at on numpy draws against JAX's pinhole_rays_device and the
    scene's analytic hit test (the host sampler's ground truth)."""
    kw = dict(n_cams=5, wh=24, n_times=3, seed=2)
    if scene == "ball":
        j, t = JBall(**kw), BallScene(**kw)
    else:
        j, t = JCloud(n_balls=8, **kw), BallCloudScene(n_balls=8, **kw)
    rng = np.random.default_rng(4)
    n = 500
    cam = rng.integers(0, 5, n)
    ti = rng.integers(0, 3, n)
    x = rng.integers(0, 24, n).astype(np.float32)
    y = rng.integers(0, 24, n).astype(np.float32)
    o_j, d_j = j_pinhole(jnp.asarray(x), jnp.asarray(y), jnp.asarray(j.K),
                         jnp.asarray(j.c2ws)[cam], True)
    o_j, d_j = np.asarray(o_j), np.asarray(d_j)
    pix_j = np.empty((n, 3), np.float32)
    for k in range(3):
        sel = ti == k
        pix_j[sel] = j._render_gt(o_j[sel], d_j[sel], j.times[k])

    data, sample_fn = t.device_sampler(device="cpu")
    b = t.sample_at(data, torch.tensor(cam), torch.tensor(ti),
                    torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(_np(b["origins"]), o_j, atol=1e-5)
    np.testing.assert_allclose(_np(b["viewdirs"]), d_j, atol=1e-5)
    np.testing.assert_allclose(_np(b["pixels"]), pix_j, atol=1e-5)
    bg = pix_j == np.asarray(j.sample(1)["color_bkgd"])
    assert 0.1 < bg.all(-1).mean() < 0.9       # hits and misses both
    np.testing.assert_array_equal(_np(b["timestamps"])[:, 0], j.times[ti])
    np.testing.assert_array_equal(_np(b["color_bkgd"]), [1.0, 1.0, 1.0])

    # the sampler draws from the generator: reproducible, in range
    g = torch.Generator().manual_seed(9)
    b1 = sample_fn(data, g, 64)
    b2 = sample_fn(data, torch.Generator().manual_seed(9), 64)
    for k in b1:
        assert torch.equal(b1[k], b2[k]), k
    assert b1["origins"].shape == (64, 3)
    assert b1["timestamps"].shape == (64, 1)
