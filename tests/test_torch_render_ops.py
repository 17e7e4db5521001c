"""The port's dense-lattice primitives against the JAX package's, on the same
numpy-drawn inputs, the JAX side jitted: ops/render.py's four functions
(with prefix_trans, and the chunked-prefix equivalence of JAX
tests/test_render.py:63), the unpacked distortion_loss / rgbper_loss,
march_rays, and the dense-lattice renderers render_rays and
render_rays_budget on an analytic f32 field (the real field's bf16 MLPs
are held in test_torch_field.py and, through the lattice marcher, in
test_torch_lattice_eval.py).

Tolerances. The scans and sums: rtol 1e-5 (f32, summed in XLA's order and
PyTorch's). march_rays: the mask exactly; t within 1e-6 relative (XLA
contracts the jitted position and lattice arithmetic into fused
multiply-adds, ROADMAP Queue 3; op by op the port's t agrees bit for bit,
tests/test_torch_packed.py). The renderers: rgb and opacity 5e-5 absolute,
depth 5e-4 on rays of opacity >= 1e-2 (the per-ray sums of the two
renderers are f32 sums in another order, and a nearly transparent ray's
depth, sum / max(opacity, eps), is their rounding noise: ROADMAP Queue 3),
the losses' internals 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.engine import renderer as jr
from cednerf_tpu.ops import losses as jl
from cednerf_tpu.ops import occupancy as jo
from cednerf_tpu.ops import render as jrn
from cednerf_torch.bridge import occ_from_numpy
from cednerf_torch.engine import renderer as tr
from cednerf_torch.ops import losses as tl
from cednerf_torch.ops import occupancy as to
from cednerf_torch.ops import render as trn

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)


def _case(seed, r=6, s=24):
    """t-sorted intervals, densities, a mask, colours and pixels."""
    rng = np.random.default_rng(seed)
    t0 = np.cumsum(rng.uniform(0.01, 0.1, (r, s)), axis=1)
    t1 = t0 + rng.uniform(0.01, 0.05, (r, s))
    sigma = rng.uniform(0, 20, (r, s))
    mask = rng.uniform(size=(r, s)) > 0.3
    rgbs = rng.uniform(size=(r, s, 3))
    pixels = rng.uniform(size=(r, 3))
    ray_w = (rng.uniform(size=r) > 0.3).astype(np.float32)
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return f(t0), f(t1), f(sigma), mask, f(rgbs), f(pixels), ray_w


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.asarray(a)) for a in arrays])


def _close(got, want, rtol=1e-5, atol=1e-7, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("prefix", [False, True])
def test_render_ops_match_jax(prefix):
    t0, t1, sig, mask, rgbs, _, _ = _case(0)
    pre = np.random.default_rng(1).uniform(0.1, 1, t0.shape[0]).astype(
        np.float32) if prefix else None
    (jt0, jt1, js, jm, jrgb), (tt0, tt1, ts, tm, trgb) = _both(
        t0, t1, sig, mask, rgbs)
    jpre = None if pre is None else jnp.asarray(pre)
    tpre = None if pre is None else torch.from_numpy(pre)
    want = jax.jit(lambda *a: jrn.render_weights_from_density(
        *a, prefix_trans=jpre))(jt0, jt1, js, jm)
    got = trn.render_weights_from_density(tt0, tt1, ts, tm,
                                          prefix_trans=tpre)
    for name, g, w in zip(("weights", "trans", "alphas"), got, want):
        _close(g, w, msg=name)
    w_j, w_t = want[0], got[0]
    bkgd = np.asarray([1.0, 0.2, 0.0], np.float32)
    jcomp = jax.jit(jrn.composite)(w_j, jrgb, jt0, jt1, jm,
                                   jnp.asarray(bkgd))
    tcomp = trn.composite(w_t, trgb, tt0, tt1, tm, torch.from_numpy(bkgd))
    for name, g, w in zip(("rgb", "opacity", "depth"), tcomp, jcomp):
        _close(g, w, msg=name)
    for vals in (None, "rgb"):
        jv = None if vals is None else jrgb
        tv = None if vals is None else trgb
        _close(trn.accumulate_along_rays(w_t, tv, tm),
               jax.jit(jrn.accumulate_along_rays)(w_j, jv, jm))
    for reduce in ("mean", "sum"):
        for weighted in (False, True):
            want_r = jax.jit(lambda v, m, w: jrn.reduce_along_rays(
                v, m, weights=w, reduce=reduce))(
                jrgb, jm, w_j if weighted else None)
            got_r = trn.reduce_along_rays(trgb, tm,
                                          weights=w_t if weighted else None,
                                          reduce=reduce)
            _close(got_r, want_r, msg=f"{reduce} {weighted}")


def test_prefix_trans_chunking_equivalence():
    """All S samples at once equal two halves where the second carries the
    first's residual transmittance (cednerf/render.py:42-56), and the
    port's halves equal JAX's."""
    t0, t1, sig, mask, _, _, _ = _case(2, r=3, s=20)
    (jt0, jt1, js, jm), (tt0, tt1, ts, tm) = _both(t0, t1, sig, mask)
    full = trn.render_weights_from_density(tt0, tt1, ts, tm)[0]
    h = 10
    w1 = trn.render_weights_from_density(tt0[:, :h], tt1[:, :h], ts[:, :h],
                                         tm[:, :h])[0]
    prefix = 1.0 - w1.sum(-1)
    w2 = trn.render_weights_from_density(tt0[:, h:], tt1[:, h:], ts[:, h:],
                                         tm[:, h:], prefix_trans=prefix)[0]
    _close(torch.cat([w1, w2], dim=1), full.numpy(), rtol=1e-4, atol=1e-6)
    jw1 = jrn.render_weights_from_density(jt0[:, :h], jt1[:, :h], js[:, :h],
                                          jm[:, :h])[0]
    jw2 = jax.jit(jrn.render_weights_from_density)(
        jt0[:, h:], jt1[:, h:], js[:, h:], jm[:, h:],
        1.0 - jnp.sum(jw1, axis=-1))[0]
    _close(w2, jw2)


def test_dense_losses_match_jax():
    t0, t1, sig, mask, rgbs, pixels, ray_w = _case(3)
    (jt0, jt1, js, jm, jrgb, jpix, jrw), (tt0, tt1, ts, tm, trgb, tpix,
                                         trw) = _both(t0, t1, sig, mask,
                                                      rgbs, pixels, ray_w)
    jw = jrn.render_weights_from_density(jt0, jt1, js, jm)[0]
    tw = trn.render_weights_from_density(tt0, tt1, ts, tm)[0]
    for rw in (False, True):
        jr_ = jrw if rw else None
        tr_ = trw if rw else None
        want = jax.jit(jl.distortion_loss)(jw, jt0, jt1, jm, jr_)
        got = tl.distortion_loss(tw, tt0, tt1, tm, ray_weights=tr_)
        assert float(want) > 1e-4
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        want = jax.jit(jl.rgbper_loss)(jrgb, jpix, jw, jm, jr_)
        got = tl.rgbper_loss(trgb, tpix, tw, tm, ray_weights=tr_)
        assert float(want) > 1e-4
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def _rays(seed, r):
    """Rays from a shell of radius 3-4 aimed near the origin; one in eight
    misses the box."""
    rng = np.random.default_rng(seed)
    d0 = rng.normal(size=(r, 3))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    origins = (d0 * rng.uniform(3, 4, (r, 1))).astype(np.float32)
    target = rng.uniform(-1, 1, (r, 3))
    target[::8] = origins[::8] * 3.0
    v = target - origins
    viewdirs = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
        np.float32)
    ts_ = rng.uniform(0, 1, (r, 1)).astype(np.float32)
    return origins, viewdirs, ts_


def _occ(seed, res=16, levels=1, p=0.3):
    rng = np.random.default_rng(seed)
    j = jo.create_occ_grid(AABB, res, levels)
    bins = rng.uniform(size=j.binaries.shape) < p
    occs = np.where(bins, 0.5, 0.0).astype(np.float32).reshape(levels, -1)
    j = j._replace(occs=jnp.asarray(occs), binaries=jnp.asarray(bins))
    return j, occ_from_numpy(occs, bins, np.asarray(j.aabbs), device="cpu")


@pytest.mark.parametrize("levels,cone,step", [(1, 0.0, 5e-2),
                                              (2, 4e-3, 2e-2)])
def test_march_rays_matches_jax(levels, cone, step):
    o, d, _ = _rays(levels, 96)
    jocc, tocc = _occ(levels, levels=levels)
    key = jax.random.PRNGKey(levels)
    jitter = np.array(jax.random.uniform(key, (96,)))
    kw = dict(near_plane=0.1, far_plane=1e10, render_step_size=step,
              cone_angle=cone, max_march_steps=160, s_max=24)
    want = jax.jit(lambda s, a, b, k: jo.march_rays(
        s, a, b, stratified_key=k, **kw))(jocc, jnp.asarray(o),
                                           jnp.asarray(d), key)
    got = to.march_rays(tocc, torch.from_numpy(o), torch.from_numpy(d),
                        jitter=torch.from_numpy(jitter), **kw)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    for name in ("t_starts", "t_ends"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, err_msg=name)
    m = got.mask.numpy()
    assert 0 < m.sum() < m.size and m.sum(-1).max() == 24   # a ray is cut
    assert got.num_valid.item() == int(want.num_valid)


def _fields():
    """An f32 field on both sides: density and colour smooth in position,
    time and direction, with the loss internals (latent, weight)."""

    def fn(xp, pos, t, d):
        r2 = (pos ** 2).sum(-1, keepdims=True)
        dens = 30.0 * xp.exp(-2.0 * r2) * (1.0 + 0.5 * t)
        rgb = 0.5 + 0.4 * xp.sin(3.0 * pos + d)
        internal = {"latent_losses": (pos[:, :2] * t) ** 2,
                    "weight_losses": 0.5 + 0.3 * xp.sin(pos[:, :1]),
                    "selector": (pos[:, 0] > -0.2).astype(xp.float32)
                    if xp is jnp else (pos[:, 0] > -0.2).float()}
        return rgb, dens, internal

    class J:
        def apply(self, params, pos, t, d, return_internal=False):
            rgb, dens, internal = fn(jnp, pos, t, d)
            res = {"density": dens}
            if return_internal:
                res["internal"] = internal
            return rgb, res

    class T:
        def __call__(self, pos, t, d, return_internal=False):
            rgb, dens, internal = fn(torch, pos, t, d)
            res = {"density": dens}
            if return_internal:
                res["internal"] = internal
            return rgb, res

    return J(), T()


def _check_result(got, want, extras=()):
    seen = np.asarray(want.opacity)[:, 0] >= 1e-2
    for name, tol in (("rgb", 5e-5), ("opacity", 5e-5), ("depth", 5e-4)):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name == "depth":
            g, w = g[seen], w[seen]
        np.testing.assert_allclose(g, w, atol=tol, err_msg=name)
    assert got.n_samples.item() == int(want.n_samples)
    for name in extras:
        np.testing.assert_allclose(got.extras[name].numpy(),
                                   np.asarray(want.extras[name]), atol=5e-5,
                                   err_msg=name)
    assert 0.05 < got.opacity.mean().item() < 0.95


@pytest.mark.parametrize("alpha_thre,train", [(0.0, True), (1e-2, True),
                                              (1e-2, False)])
def test_render_rays_matches_jax(alpha_thre, train):
    """train=True adds the latent and weight losses (the proposal
    trainer's reading); train=False is the eval path of budgeted=False."""
    o, d, t = _rays(4, 64)
    jocc, tocc = _occ(4, levels=2)
    kw = dict(near_plane=0.0, far_plane=1e10, render_step_size=2e-2,
              cone_angle=4e-3, max_march_steps=200, s_max=48)
    js = jax.jit(lambda s, a, b: jo.march_rays(s, a, b, **kw))(
        jocc, jnp.asarray(o), jnp.asarray(d))
    ts = to.RaySamples(*(torch.from_numpy(np.array(a)) for a in js))
    jf, tf = _fields()
    bkgd = np.ones(3, np.float32)
    rk = dict(alpha_thre=alpha_thre, train=train)
    want = jax.jit(lambda *a: jr.render_rays(jf, None, *a, **rk))(
        jnp.asarray(o), jnp.asarray(d), js, jnp.asarray(t),
        jnp.asarray(bkgd), jnp.float32(0.02))
    got = tr.render_rays(tf, torch.from_numpy(o), torch.from_numpy(d), ts,
                         torch.from_numpy(t), torch.from_numpy(bkgd),
                         torch.tensor(0.02), **rk)
    _check_result(got, want, ("weights", "trans") + (
        ("latent_losses", "weight_losses") if train else ()))
    assert ("latent_losses" in got.extras) == train


@pytest.mark.parametrize("alpha_thre,budget", [(0.0, 4096), (1e-2, 4096),
                                               (0.0, 1536)])
def test_render_rays_budget_matches_jax(alpha_thre, budget):
    """The dense-lattice train renderer on a 2-level cone-angle lattice; a
    budget of 1536 cuts rays (complete < 1)."""
    o, d, t = _rays(6, 96)
    jocc, tocc = _occ(6, levels=2)
    key = jax.random.PRNGKey(6)
    jitter = np.array(jax.random.uniform(key, (96,)))
    kw = dict(near_plane=0.0, far_plane=1e10, render_step_size=2e-2,
              cone_angle=4e-3, max_march_steps=128)
    with jax.disable_jit():     # op by op: the same lattice bits
        jc = jo.march_candidates(jocc, jnp.asarray(o), jnp.asarray(d),
                                 stratified_key=key, **kw)
    tc = to.march_candidates(tocc, torch.from_numpy(o), torch.from_numpy(d),
                             jitter=torch.from_numpy(jitter), **kw)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    jf, tf = _fields()
    bkgd = np.ones(3, np.float32)
    rk = dict(budget=budget, alpha_thre=alpha_thre, train=True)
    want = jax.jit(lambda *a: jr.render_rays_budget(jf, None, *a, **rk))(
        jnp.asarray(o), jnp.asarray(d), jc, jnp.asarray(t),
        jnp.asarray(bkgd), jnp.float32(0.02))
    got = tr.render_rays_budget(tf, torch.from_numpy(o), torch.from_numpy(d),
                                tc, torch.from_numpy(t),
                                torch.from_numpy(bkgd), torch.tensor(0.02),
                                **rk)
    _check_result(got, want, ("weights", "trans", "latent_losses",
                              "weight_losses"))
    np.testing.assert_array_equal(got.extras["complete"].numpy(),
                                  np.asarray(want.extras["complete"]))
    assert got.extras["n_valid"].item() == int(want.extras["n_valid"])
    cut = got.extras["complete"].mean().item()
    assert (cut < 1.0) == (budget < tc.valid.sum().item())
