"""The lattice eval marcher (make_eval_render_fn's cone-angle and
budgeted=False path) against the JAX package's, and within the port the
JAX tests/test_eval_renderer.py properties.

Against JAX: the port's hypernerf_config and dynerf_config (cone_angle
4e-3 on a 2- and a 4-level grid, alpha_thre 1e-2, near plane 0.2), cut to a
16^3 grid, a 512- and a 1024-step lattice and a small field that keeps the preset's
max resolution (4096, 8192) with a 2^12 hashmap, on bridged weights
(tables uniform +-2 so that the frame is non-trivial): budgeted at
(s_max 64, budget_per_ray 64), a per-ray budget of 8 that forces several
passes, alpha_thre 0, and budgeted=False, each a 24x24 frame through
render_image. Tolerances are tests/test_torch_renderer.py's: rgb and
opacity 5e-3 absolute, depth 2e-2 on rays of opacity >= 1e-2 (the bf16
MLPs of the two fields round differently; depth of a nearly transparent
ray is rounding noise, ROADMAP Queue 3).

Within the port (a small f32-scale field, as JAX's _setup): the multi-pass
marcher equals the single dense pass at early_stop_eps=-1 for any budget
(alpha_thre 0 and 1e-3), the s_max cap bounds opacity, the default early
stop moves results by at most ~eps, and the segment path equals the
lattice on a cone_angle == 0 config, all at JAX's rtol 1e-4, atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.engine.cli import build_field as j_build_field
from cednerf_tpu.engine.config import ModelFlags as JFlags
from cednerf_tpu.engine.config import dynerf_config as j_dynerf_config
from cednerf_tpu.engine.config import hypernerf_config as j_hyper_config
from cednerf_tpu.engine.renderer import make_eval_render_fn as j_make_fn
from cednerf_tpu.engine.renderer import render_image as j_render_image
from cednerf_tpu.ops.occupancy import create_occ_grid as j_create_occ
from cednerf_torch.bridge import occ_from_numpy, params_from_numpy
from cednerf_torch.datasets.rays import pinhole_rays
from cednerf_torch.engine.cli import build_field
from cednerf_torch.engine.config import (ModelFlags, dnerf_config,
                                         dynerf_config, hypernerf_config)
from cednerf_torch.engine.renderer import (LatticeEvalRenderer,
                                           SegEvalRenderer, eval_chunk_for,
                                           make_eval_render_fn, render_image)
from cednerf_torch.models.field import DNGPRadianceField
from cednerf_torch.ops.occupancy import create_occ_grid

FLAGS = dict(use_div_offsets=True, use_feat_predict=True,
             use_time_embedding=True, use_time_attenuation=True)
SHRINK = dict(grid_resolution=16, log2_hashmap_size=12, max_table_rows=256,
              hash_n_levels=4)
# (port preset, JAX preset, lattice steps): enough geometric steps to pass
# the scene from the camera (DyNeRF's rays start inside its +-8 box, at
# the near plane, where the steps are smallest)
PRESETS = {"hypernerf": (lambda: hypernerf_config("vrig_3dprinter"),
                         lambda: j_hyper_config("vrig_3dprinter"), 512),
           "dynerf": (dynerf_config, j_dynerf_config, 1024)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Hundreds of small ops per pass: one OpenMP thread per worker keeps
    the suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _frame(w=24):
    K = np.array([[w * 1.2, 0, w / 2], [0, w * 1.2, w / 2], [0, 0, 1]],
                 np.float32)
    c2w = np.array([[1, 0, 0, 0.1], [0, 0, -1, -3.2], [0, 1, 0, 0.2]],
                   np.float32)
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="xy")
    o, d, _ = pinhole_rays(xx.reshape(-1), yy.reshape(-1), K,
                           np.broadcast_to(c2w, (w * w, 3, 4)), True)
    return o.reshape(w, w, 3), d.reshape(w, w, 3)


def _scene(preset, seed=0):
    """(JAX field, params, cfg, grid; port field, cfg, grid) of a shrunken
    preset: bridged weights, a ball of cells plus 2% strays on each
    level."""
    port, jax_, steps = PRESETS[preset]
    tcfg = dataclasses.replace(port(), max_march_steps=steps, **SHRINK)
    jcfg = dataclasses.replace(jax_(), max_march_steps=steps, **SHRINK)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jf = j_build_field(jcfg, JFlags(**FLAGS))
    params = jax.tree_util.tree_map(np.array, jf.init(
        jax.random.PRNGKey(seed), jnp.zeros((4, 3)), jnp.zeros((4, 1)),
        jnp.ones((4, 3)), return_internal=True))
    rng = np.random.default_rng(seed)
    enc = params["params"]["hash_encoder"]
    for k, v in enc.items():
        enc[k] = rng.uniform(-2, 2, v.shape).astype(np.float32)
    # density ~ e^2 at zero features: samples survive alpha_thre 1e-2 at
    # the cone lattice's ~0.01 steps
    params["params"]["mlp_base"]["out"]["bias"][0] = 3.0
    tf = build_field(tcfg, ModelFlags(**FLAGS), device="cpu")
    tf.load_state_dict(params_from_numpy(params), strict=True)
    res, lv = tcfg.grid_resolution, tcfg.grid_nlvl
    jocc = j_create_occ(jcfg.aabb, res, lv)
    aabbs = np.asarray(jocc.aabbs)
    c = (np.indices((res,) * 3).transpose(1, 2, 3, 0) + 0.5) / res
    bins = np.stack([
        (np.linalg.norm(aabbs[l, :3] + c * (aabbs[l, 3:] - aabbs[l, :3]),
                        axis=-1) < 1.0)
        | (rng.uniform(size=(res,) * 3) < 0.02) for l in range(lv)])
    occs = np.where(bins, 0.5, 0.0).astype(np.float32).reshape(lv, -1)
    jocc = jocc._replace(occs=jnp.asarray(occs), binaries=jnp.asarray(bins))
    tocc = occ_from_numpy(occs, bins, aabbs, device="cpu")
    return jf, params, jcfg, jocc, tf, tcfg, tocc


@pytest.mark.parametrize("preset,s_max,bpr,budgeted,alpha,multi", [
    ("hypernerf", 64, 64, True, None, False),   # budget = the whole lattice
    ("hypernerf", 64, 8, True, None, True),     # several passes
    ("hypernerf", 64, 64, True, 0.0, False),    # no alpha pruning
    ("hypernerf", 64, 64, False, None, False),  # one dense pass
    ("dynerf", 48, 4, True, None, True),
    ("dynerf", 48, 16, False, None, False),
])
def test_lattice_render_image_matches_jax(preset, s_max, bpr, budgeted,
                                          alpha, multi):
    jf, params, jcfg, jocc, tf, tcfg, tocc = _scene(preset)
    if alpha is not None:
        jcfg = dataclasses.replace(jcfg, alpha_thre=alpha)
        tcfg = dataclasses.replace(tcfg, alpha_thre=alpha)
    o, d = _frame()
    t, bkgd = 0.4, np.zeros(3, np.float32)
    kw = dict(s_max=s_max, budgeted=budgeted, budget_per_ray=bpr)
    jfn = j_make_fn(jf, jcfg, **kw)
    want = j_render_image(jf, params, jocc, jfn, o, d, jnp.float32(t),
                          jnp.asarray(bkgd), chunk=eval_chunk_for(jcfg))
    tfn = make_eval_render_fn(tf, tcfg, **kw)
    assert isinstance(tfn, LatticeEvalRenderer)
    got = render_image(tf, tocc, tfn, o, d, t, bkgd,
                       chunk=eval_chunk_for(tcfg))
    assert len(tfn.pass_log) == 1 and (tfn.pass_log[0][0] > 1) == multi
    opac = np.asarray(want[1])
    assert 0.05 < opac.mean() < 0.95, opac.mean()   # a non-trivial frame
    seen = opac[..., 0] >= 1e-2
    for name, g, w_, tol in (("rgb", got[0], want[0], 5e-3),
                             ("opacity", got[1], want[1], 5e-3),
                             ("depth", got[2][seen], np.asarray(want[2])[seen],
                              2e-2)):
        assert g.shape == np.asarray(w_).shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w_), atol=tol,
                                   err_msg=name)


def test_bridge_carries_preset_tables_and_grid():
    """The full-width HyperNeRF field's level layout (max resolution 4096,
    dense and hashed levels) and a 2-level grid cross the bridge: the
    port's state dict has JAX's paths and shapes, and the grid's arrays
    arrive bit for bit."""
    jf, params, jcfg, jocc, tf, tcfg, tocc = _scene("hypernerf")
    sd = tf.state_dict()
    bridged = params_from_numpy(params)
    assert sd.keys() == bridged.keys()
    for k, v in bridged.items():
        assert torch.equal(sd[k], v), k
    assert tf.hash_encoder.bspec.level_scales()[-1] > 2048
    for a, b in zip(tocc, (jocc.occs, jocc.binaries, jocc.aabbs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tocc.levels == 2


def _setup(seed=0, n_rays=32, alpha_thre=0.0, cone=0.0):
    """JAX tests/test_eval_renderer.py's scene, on the port: an 8^3 grid
    (all occupied), a small field, rays from z = -3 toward +z."""
    cfg = dataclasses.replace(
        dnerf_config(max_steps=100), grid_resolution=8, max_march_steps=64,
        render_step_size=5e-2, eval_s_max=64, alpha_thre=alpha_thre,
        cone_angle=cone)
    field = DNGPRadianceField(aabb=cfg.aabb, n_levels=3, dst_resolution=32,
                              base_resolution=8, log2_hashmap_size=10)
    field.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for t in field.hash_encoder.tables().values():
            t.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(
                seed + 1))
    occ = create_occ_grid(cfg.aabb, cfg.grid_resolution, cfg.grid_nlvl,
                          device="cpu")
    occ = occ._replace(binaries=torch.ones_like(occ.binaries))
    rng = np.random.default_rng(seed)
    origins = np.zeros((n_rays, 3), np.float32)
    origins[:, 2] = -3.0
    viewdirs = rng.normal(0, 0.15, (n_rays, 3)).astype(np.float32)
    viewdirs[:, 2] += 1.0
    viewdirs /= np.linalg.norm(viewdirs, axis=-1, keepdims=True)
    return (cfg, field, occ, torch.from_numpy(origins),
            torch.from_numpy(viewdirs), torch.ones(3))


def _run(fn, occ, o, d, bkgd):
    return [a.numpy() for a in fn(occ, o, d, 0.5, bkgd)]


@pytest.mark.parametrize("seed,alpha,cone,bpr", [(0, 0.0, 0.0, 4),
                                                 (3, 1e-3, 0.0, 8),
                                                 (4, 1e-3, 4e-3, 4)])
def test_multipass_matches_dense(seed, alpha, cone, bpr):
    """A tiny per-pass budget (many passes) reproduces the dense pass when
    early termination is off."""
    cfg, field, occ, o, d, bkgd = _setup(seed, alpha_thre=alpha, cone=cone)
    dense = make_eval_render_fn(field, cfg, budgeted=False)
    multi = make_eval_render_fn(field, cfg, budget_per_ray=bpr,
                                early_stop_eps=-1.0, impl="lattice")
    r0, r1 = _run(dense, occ, o, d, bkgd), _run(multi, occ, o, d, bkgd)
    assert multi.pass_log[0][0] > 1
    for a, b in zip(r0, r1):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert 0.05 < r0[1].mean() < 0.99


def test_early_termination_close_to_exact():
    cfg, field, occ, o, d, bkgd = _setup(seed=1, cone=4e-3)
    exact = make_eval_render_fn(field, cfg, budget_per_ray=8,
                                early_stop_eps=-1.0)
    fast = make_eval_render_fn(field, cfg, budget_per_ray=8,
                               early_stop_eps=1e-4)
    for a, b in zip(_run(exact, occ, o, d, bkgd), _run(fast, occ, o, d,
                                                        bkgd)):
        np.testing.assert_allclose(a, b, atol=2e-3)


def test_s_max_caps_per_ray_samples():
    """A lower s_max truncates deep samples: opacity can only decrease, and
    rays with more than s_max valid candidates lose contribution."""
    cfg, field, occ, o, d, bkgd = _setup(seed=2, cone=4e-3)
    full = make_eval_render_fn(field, cfg, s_max=64, budget_per_ray=8,
                               early_stop_eps=-1.0)
    capped = make_eval_render_fn(field, cfg, s_max=4, budget_per_ray=8,
                                 early_stop_eps=-1.0)
    _, opac_full, _ = _run(full, occ, o, d, bkgd)
    _, opac_cap, _ = _run(capped, occ, o, d, bkgd)
    assert (opac_cap <= opac_full + 1e-5).all()
    assert opac_cap.sum() < opac_full.sum()


@pytest.mark.parametrize("alpha", [0.0, 1e-3])
def test_seg_matches_lattice_uniform_steps(alpha):
    """On a cone_angle == 0 config the segment path equals the lattice
    marcher (a sparse random grid: the segment probe must drop nothing)."""
    cfg, field, occ, o, d, bkgd = _setup(seed=5, alpha_thre=alpha)
    bins = torch.from_numpy(
        np.random.default_rng(7).random(tuple(occ.binaries.shape)) < 0.3)
    occ = occ._replace(binaries=bins)
    lat = make_eval_render_fn(field, cfg, budget_per_ray=8,
                              early_stop_eps=-1.0, impl="lattice")
    seg = make_eval_render_fn(field, cfg, budget_per_ray=8,
                              early_stop_eps=-1.0)
    assert isinstance(seg, SegEvalRenderer)
    assert isinstance(lat, LatticeEvalRenderer)
    r0, r1 = _run(lat, occ, o, d, bkgd), _run(seg, occ, o, d, bkgd)
    for a, b in zip(r0, r1):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
