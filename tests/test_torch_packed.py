"""The port's packed train path against the JAX package: the candidate
march, the segment helpers, pack_budget_samples, render_packed and the
packed losses, on the same numpy-drawn inputs.

Tolerances. Integer outputs (valid, ray, starts, counts, complete, n_valid)
are exact. The march is compared with JAX run op by op (not jitted), where
XLA contracts nothing, so t_starts agree bit for bit and `valid`, which
floors positions, agrees exactly. Slot floats that come through a
segment_broadcast are a telescoped f32 sum of first differences, summed in
another order than XLA's: atol 1e-5 (inputs are O(1)-O(10)). The renderer
runs on an analytic f32 field on both sides (the real field's bf16 MLPs are
held in test_torch_field.py). Per-slot transmittance and weights come from
differences of a global f32 optical-depth cumsum, and per-ray rgb and
opacity are boundary differences of a global f32 channel cumsum; both
running totals reach ~60-100 here (an ulp of 4e-6 to 8e-6) and are summed
in another order than XLA's: atol 5e-5, and depth (divided by opacity)
5e-4.
The losses are compared at rtol 1e-4.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.engine import renderer as jr
from cednerf_tpu.ops import losses as jl
from cednerf_tpu.ops import occupancy as jo
from cednerf_tpu.ops import segments as js
from cednerf_torch.bridge import occ_from_numpy
from cednerf_torch.engine import renderer as tr
from cednerf_torch.ops import losses as tl
from cednerf_torch.ops import occupancy as to
from cednerf_torch.ops import segments as ts

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
STEP = 5e-2
M = 128


def _rays(seed, r):
    """Rays from a shell of radius 3-4 aimed near the origin; one in eight
    misses the box."""
    rng = np.random.default_rng(seed)
    d0 = rng.normal(size=(r, 3))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    origins = (d0 * rng.uniform(3, 4, (r, 1))).astype(np.float32)
    target = rng.uniform(-1, 1, (r, 3))
    target[::8] = origins[::8] * 3.0          # aimed away: misses
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
    t = occ_from_numpy(occs, bins, np.asarray(j.aabbs), device="cpu")
    return j, t


@functools.lru_cache(maxsize=None)
def _march(seed, r, levels=1, cone=0.0):
    """Rays, the JAX march (op by op) and the port's, once per argument set
    (read-only to every caller)."""
    o, d, t = _rays(seed, r)
    jocc, tocc = _occ(seed, levels=levels)
    key = jax.random.PRNGKey(seed)
    jitter = np.asarray(jax.random.uniform(key, (r,)))
    kw = dict(near_plane=0.0, far_plane=1e10, render_step_size=STEP,
              cone_angle=cone, max_march_steps=M)
    with jax.disable_jit():
        jc = jo.march_candidates(jocc, jnp.asarray(o), jnp.asarray(d),
                                 stratified_key=key, **kw)
    tc = to.march_candidates(tocc, torch.from_numpy(o), torch.from_numpy(d),
                             jitter=torch.from_numpy(jitter), **kw)
    return (o, d, t), jc, tc


@pytest.mark.parametrize("levels,cone", [(1, 0.0), (2, 0.0), (1, 0.004)])
def test_march_candidates_matches_jax(levels, cone):
    _, jc, tc = _march(levels, 96, levels, cone)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    np.testing.assert_array_equal(tc.t_starts.numpy(),
                                  np.asarray(jc.t_starts))
    np.testing.assert_array_equal(tc.dts.numpy(), np.asarray(jc.dts))
    assert 0.05 < tc.valid.float().mean().item() < 0.5


def test_march_jitter_from_generator_and_probe_steps_raise():
    o, d, _ = _rays(0, 16)
    _, tocc = _occ(0)
    kw = dict(near_plane=0.0, far_plane=1e10, render_step_size=STEP,
              max_march_steps=M)
    a = to.march_candidates(tocc, torch.from_numpy(o), torch.from_numpy(d),
                            generator=torch.Generator().manual_seed(1), **kw)
    b = to.march_candidates(tocc, torch.from_numpy(o), torch.from_numpy(d),
                            **kw)
    shift = (a.t_starts - b.t_starts)[:, 0]
    assert bool(((shift >= 0) & (shift < STEP)).all())
    with pytest.raises(NotImplementedError, match="scanned"):
        to.march_candidates(tocc, torch.from_numpy(o), torch.from_numpy(d),
                            probe_steps=4 * M, **kw)


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_segment_helpers_match_jax(n_blocks):
    rng = np.random.default_rng(n_blocks)
    r, budget = 64, 512
    counts = rng.integers(0, 12, r).astype(np.int32)
    starts = np.asarray(jr._block_starts(jnp.asarray(counts), budget,
                                         n_blocks))
    got = tr._block_starts(torch.from_numpy(counts), budget, n_blocks)
    np.testing.assert_array_equal(got.numpy(), starts)
    per_slot = rng.normal(size=(budget, 5)).astype(np.float32)
    vals = rng.normal(size=(r, 3)).astype(np.float32)
    for x in (per_slot, per_slot[:, 0]):
        want = js.segment_sum(jnp.asarray(x), jnp.asarray(starts),
                              jnp.asarray(counts), budget)
        got = ts.segment_sum(torch.from_numpy(x), torch.from_numpy(starts),
                             torch.from_numpy(counts), budget)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for v in (vals, vals[:, 0]):
        want = js.segment_broadcast(jnp.asarray(v), jnp.asarray(starts),
                                    budget, n_blocks)
        got = ts.segment_broadcast(torch.from_numpy(v),
                                   torch.from_numpy(starts), budget, n_blocks)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("assembly,uniform", [("gather", False),
                                              ("cumsum", False),
                                              ("cumsum", True)])
@pytest.mark.parametrize("budget", [1024, 8192])
def test_pack_budget_samples_matches_jax(assembly, uniform, budget):
    (o, d, t), jc, tc = _march(3, 96)
    kw = dict(budget=budget, compact_impl="rayfold", assembly_impl=assembly,
              uniform_dt=STEP if uniform else None)
    jp = jr.pack_budget_samples(jnp.asarray(o), jnp.asarray(d), jc,
                                jnp.asarray(t), **kw)
    tp = tr.pack_budget_samples(torch.from_numpy(o), torch.from_numpy(d), tc,
                                torch.from_numpy(t), **kw)
    for name in ("valid", "ray", "starts", "counts", "complete", "n_valid"):
        np.testing.assert_array_equal(
            getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
            err_msg=name)
    used = np.asarray(jp.valid)
    for name in ("pos", "dirs", "ts", "t_starts", "dts"):
        np.testing.assert_allclose(
            getattr(tp, name).numpy()[used],
            np.asarray(getattr(jp, name))[used], atol=1e-5, err_msg=name)
    if budget == 1024:
        assert not bool(tp.complete.all())       # the budget cut rays
    else:
        assert bool(tp.complete.all())


class _Fields(NamedTuple):
    jax: object
    torch: object


def _analytic_fields():
    """An f32 field on both sides: density and colour as smooth functions
    of position, time and direction, with the loss internals."""

    def fn(xp, pos, t, d):
        r2 = (pos ** 2).sum(-1, keepdims=True)
        dens = 8.0 * xp.exp(-2.0 * r2) * (1.0 + 0.5 * t)
        rgb = 0.5 + 0.4 * xp.sin(3.0 * pos + d)
        lat = (pos[:, :1] * t) ** 2 * xp.ones_like(pos[:, :2])
        return rgb, dens, lat

    class J:
        def apply(self, params, pos, t, d, return_internal=False):
            rgb, dens, lat = fn(jnp, pos, t, d)
            res = {"density": dens}
            if return_internal:
                res["internal"] = {"latent_losses": lat}
            return rgb, res

    class T:
        def __call__(self, pos, t, d, return_internal=False):
            rgb, dens, lat = fn(torch, pos, t, d)
            res = {"density": dens}
            if return_internal:
                res["internal"] = {"latent_losses": lat}
            return rgb, res

    return _Fields(J(), T())


def _render(budget, assembly, alpha_thre=0.0):
    (o, d, t), jc, tc = _march(5, 96)
    f = _analytic_fields()
    bkgd = np.ones(3, np.float32)
    kw = dict(budget=budget, compact_impl="rayfold", assembly_impl=assembly,
              uniform_dt=STEP, alpha_thre=alpha_thre, train=True)
    jo_ = jr.render_rays_budget_packed(
        f.jax, None, jnp.asarray(o), jnp.asarray(d), jc, jnp.asarray(t),
        jnp.asarray(bkgd), jnp.float32(0.02), **kw)
    to_ = tr.render_rays_budget_packed(
        f.torch, torch.from_numpy(o), torch.from_numpy(d), tc,
        torch.from_numpy(t), torch.from_numpy(bkgd), torch.tensor(0.02),
        **kw)
    return jo_, to_


@pytest.mark.parametrize("assembly", ["gather", "cumsum"])
@pytest.mark.parametrize("alpha_thre", [0.0, 1e-3])
def test_render_packed_matches_jax(assembly, alpha_thre):
    jo_, to_ = _render(4096, assembly, alpha_thre)
    for name, tol in (("rgb", 5e-5), ("opacity", 5e-5), ("depth", 5e-4)):
        np.testing.assert_allclose(getattr(to_, name).numpy(),
                                   np.asarray(getattr(jo_, name)), atol=tol,
                                   err_msg=name)
    assert to_.n_samples.item() == float(jo_.n_samples)
    for name in ("weights_p", "trans_p", "latent_p"):
        np.testing.assert_allclose(to_.extras[name].numpy(),
                                   np.asarray(jo_.extras[name]), atol=5e-5,
                                   err_msg=name)
    assert 0.05 < to_.opacity.mean().item() < 0.95


def test_packed_losses_match_jax():
    jo_, to_ = _render(4096, "cumsum")
    je, te = jo_.extras, to_.extras
    budget = 4096
    rng = np.random.default_rng(0)
    pixels = rng.uniform(size=(96, 3)).astype(np.float32)
    per_slot = rng.normal(size=budget).astype(np.float32) * np.asarray(
        je["valid_p"])
    J = {k: jnp.asarray(np.asarray(v)) for k, v in je.items()
         if k != "packed"}
    T = {k: te[k] for k in J}
    jc, tc = J["complete"], T["complete"]
    cases = [
        (jl.packed_distortion_loss(J["weights_p"], J["t_starts_p"],
                                   J["dts_p"], J["starts"], J["counts"],
                                   budget, jc),
         tl.packed_distortion_loss(T["weights_p"], T["t_starts_p"],
                                   T["dts_p"], T["starts"], T["counts"],
                                   budget, tc)),
        (jl.packed_rgbper_loss(J["rgbs_p"], jnp.asarray(pixels),
                               J["weights_p"], J["starts"], J["counts"],
                               budget, jc),
         tl.packed_rgbper_loss(T["rgbs_p"], torch.from_numpy(pixels),
                               T["weights_p"], T["starts"], T["counts"],
                               budget, tc)),
        (jl.packed_ray_sum_mean(jnp.asarray(per_slot), J["starts"],
                                J["counts"], budget, jc),
         tl.packed_ray_sum_mean(torch.from_numpy(per_slot), T["starts"],
                                T["counts"], budget, tc)),
        (jl.packed_per_ray_mean(jnp.asarray(per_slot), J["valid_p"],
                                J["starts"], J["counts"], budget, None),
         tl.packed_per_ray_mean(torch.from_numpy(per_slot), T["valid_p"],
                                T["starts"], T["counts"], budget, None)),
        (jl.opacity_loss(jnp.asarray(to_.opacity.numpy()), ray_weights=jc),
         tl.opacity_loss(to_.opacity, ray_weights=tc)),
        (jl.acc_entropy_loss(jnp.asarray(to_.opacity.numpy()),
                             ray_weights=jc),
         tl.acc_entropy_loss(to_.opacity, ray_weights=tc)),
    ]
    for i, (want, got) in enumerate(cases):
        assert abs(float(want)) > 1e-6, i
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4,
                                   err_msg=str(i))
