"""The serving slice as a whole: the port's segment eval renderer +
render_image against the JAX ones, on bridged weights, a 16^3 occupancy grid
and a 32x32 image.

Tolerances: rgb and opacity within 5e-3 absolute, depth within 2e-2 (the
scene spans 3 units) on rays of opacity >= 1e-2 (measured on this scene:
rgb 2.6e-4, opacity 4.6e-4, depth 3.6e-3). Depth is compared only
there: a ray's sums are differences of one chunk-wide prefix scan, so a
nearly transparent ray's depth (sum / max(opacity, eps)) is rounding noise
of that scan, on either side. Why any tolerance: both fields run bf16 MLPs that round
differently (test_torch_field.py), so densities differ by up to ~3%; the
JAX program also fuses ray positions into FMAs (one ulp of t). A ray whose
transmittance sits at the 1e-4 early-stop threshold can stop one pass
earlier on one side, which moves its sums by about that threshold.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cednerf_tpu.datasets.rays import pinhole_rays as j_pinhole_rays
from cednerf_tpu.engine.config import dnerf_config as j_dnerf_config
from cednerf_tpu.engine.renderer import make_eval_render_fn as j_make_fn
from cednerf_tpu.engine.renderer import render_image as j_render_image
from cednerf_tpu.models.field import DNGPRadianceField as JField
from cednerf_tpu.ops.occupancy import create_occ_grid as j_create_occ
from cednerf_torch.bridge import occ_from_numpy, params_from_numpy
from cednerf_torch.datasets.rays import pinhole_rays
from cednerf_torch.engine.config import dnerf_config
from cednerf_torch.engine.renderer import (LatticeEvalRenderer,
                                           SegEvalRenderer, eval_chunk_for,
                                           make_eval_render_fn, render_image)
from cednerf_torch.models.field import DNGPRadianceField

FIELD_KW = dict(aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), n_levels=3,
                n_features_per_level=4, base_resolution=8, dst_resolution=64,
                log2_hashmap_size=12, max_table_rows=256, use_div_offsets=True,
                use_time_embedding=True, use_time_attenuation=True,
                use_feat_predict=True, moving_step=1e-2)
CFG_KW = dict(grid_resolution=16, render_step_size=2e-2, max_march_steps=264,
              eval_s_max=64)


def _scene(seed=0, w=32):
    jf = JField(**FIELD_KW)
    params = jax.tree_util.tree_map(np.asarray, jf.init(
        jax.random.PRNGKey(seed), jnp.zeros((4, 3)), jnp.zeros((4, 1)),
        jnp.ones((4, 3)), return_internal=True))
    rng = np.random.default_rng(seed)
    for k, v in params["params"]["hash_encoder"].items():
        params["params"]["hash_encoder"][k] = rng.uniform(
            -2, 2, v.shape).astype(np.float32)
    tf = DNGPRadianceField(**FIELD_KW)
    tf.load_state_dict(params_from_numpy(params))
    # occupancy: a ball of cells plus a few stray ones
    res = CFG_KW["grid_resolution"]
    c = (np.indices((res,) * 3).transpose(1, 2, 3, 0) + 0.5) / res * 3 - 1.5
    bins = (np.linalg.norm(c, axis=-1) < 1.0) \
        | (rng.uniform(size=(res,) * 3) < 0.02)
    jocc = j_create_occ(j_dnerf_config().aabb, res, 1)._replace(
        binaries=jnp.asarray(bins[None]))
    tocc = occ_from_numpy(np.asarray(jocc.occs), bins[None],
                          np.asarray(jocc.aabbs), device="cpu")
    K = np.array([[w * 1.2, 0, w / 2], [0, w * 1.2, w / 2], [0, 0, 1]],
                 np.float32)
    c2w = np.array([[1, 0, 0, 0.1], [0, 0, -1, -3.2], [0, 1, 0, 0.2]],
                   np.float32)
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="xy")
    args = (xx.reshape(-1), yy.reshape(-1), K,
            np.broadcast_to(c2w, (w * w, 3, 4)), True)
    o, d, _ = pinhole_rays(*args)
    oj, dj, _ = j_pinhole_rays(*args)
    np.testing.assert_array_equal(o, oj)
    np.testing.assert_array_equal(d, dj)
    return jf, params, tf, jocc, tocc, o.reshape(w, w, 3), d.reshape(w, w, 3)


@pytest.mark.parametrize("s_max,t", [(64, 0.5), (16, 0.0)])
def test_seg_render_image_matches_jax(s_max, t):
    jf, params, tf, jocc, tocc, o, d = _scene()
    bkgd = np.ones(3, np.float32)
    jcfg = dataclasses.replace(j_dnerf_config(), **CFG_KW)
    tcfg = dataclasses.replace(dnerf_config(), **CFG_KW)
    jfn = j_make_fn(jf, jcfg, s_max=s_max)
    want = j_render_image(jf, params, jocc, jfn, o, d, jnp.float32(t),
                          jnp.asarray(bkgd), chunk=eval_chunk_for(tcfg))
    tfn = make_eval_render_fn(tf, tcfg, s_max=s_max)
    got = render_image(tf, tocc, tfn, o, d, t, bkgd,
                       chunk=eval_chunk_for(tcfg))
    assert len(tfn.pass_log) == 1 and sum(tfn.pass_log[0]) >= 1
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


def test_render_image_chunks_and_padding():
    """A ragged chunking (last chunk padded) renders the same frame."""
    _, _, tf, _, tocc, o, d = _scene(seed=1, w=24)
    tcfg = dataclasses.replace(dnerf_config(), **CFG_KW)
    fn = make_eval_render_fn(tf, tcfg)
    whole = render_image(tf, tocc, fn, o, d, 0.3, np.ones(3), chunk=4096)
    parts = render_image(tf, tocc, fn, o, d, 0.3, np.ones(3), chunk=200)
    assert len(fn.pass_log) == 1 + 3        # 576 rays: 200 + 200 + 176(+24)
    seen = whole[1][..., 0] >= 1e-2
    for a, b in ((whole[0], parts[0]), (whole[1], parts[1]),
                 (whole[2][seen], parts[2][seen])):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-3)


def test_unported_render_paths_raise():
    """The paths that raised before the lattice marcher was ported
    (budgeted=False, a cone-angle config) now render finite frames through
    it; what still raises: impl="seg" without a budget, and the segment
    renderer on a cone-angle config (JAX asserts the same)."""
    _, _, tf, _, tocc, o, d = _scene(w=16)
    cfg = dataclasses.replace(dnerf_config(), **CFG_KW)
    cone = dataclasses.replace(cfg, cone_angle=4e-3)
    for c, kw in ((cfg, dict(budgeted=False)), (cone, {}),
                  (cone, dict(budgeted=False))):
        fn = make_eval_render_fn(tf, c, **kw)
        assert isinstance(fn, LatticeEvalRenderer)
        rgb, opac, depth = render_image(tf, tocc, fn, o, d, 0.5, np.ones(3),
                                        chunk=eval_chunk_for(c))
        assert rgb.shape == (16, 16, 3) and depth.shape == (16, 16, 1)
        assert np.isfinite(rgb).all() and np.isfinite(depth).all()
        assert 0.0 < opac.mean() < 1.0 and fn.pass_log
    with pytest.raises(ValueError, match="budgeted"):
        make_eval_render_fn(tf, cfg, budgeted=False, impl="seg")
    with pytest.raises(NotImplementedError, match="cone_angle"):
        SegEvalRenderer(tf, cone)
