"""cednerf_torch/ops/occupancy.py against cednerf_tpu/ops/occupancy.py.

Integer and boolean outputs must be equal exactly: binaries after
update_occ_grid (the JAX random draws are replayed from its key and
injected into the port), pooled_binaries, coarse_lookup and
occupancy_lookup. The probe density is piecewise constant, so the one-ulp
position differences of XLA's fused multiply-adds cannot flip a cell.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.ops import occupancy as jocc
from cednerf_torch.ops import occupancy as tocc

ROI = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
CENTER = np.asarray([0.3, -0.2, 0.1], np.float32)


def _density_np(x, xp):
    """Ball of radius 0.9 plus a dimmer shell; density * step."""
    r = xp.sqrt(((x - xp.asarray(CENTER)) ** 2).sum(-1, keepdims=True))
    return xp.where(r < 0.9, 0.05, xp.where(r < 1.3, 0.004, 0.0))


def _state(levels, res, seed):
    j = jocc.create_occ_grid(ROI, res, levels)
    rng = np.random.default_rng(seed)
    occs = rng.uniform(0, 0.02, (levels, res ** 3)).astype(np.float32)
    occs[rng.uniform(size=occs.shape) < 0.05] = -1.0     # invisible cells
    j = j._replace(occs=jnp.asarray(occs))
    t = tocc.OccGridState(torch.from_numpy(occs),
                          torch.from_numpy(np.array(j.binaries)),
                          torch.from_numpy(np.array(j.aabbs)))
    return j, t


@pytest.mark.parametrize("all_cells,levels", [(True, 1), (False, 2)])
def test_update_occ_grid_binaries_exact(all_cells, levels):
    res = 16
    j, t = _state(levels, res, seed=levels)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda s, k: jocc.update_occ_grid(
        s, lambda x, _k: _density_np(x, jnp), k, all_cells=all_cells,
        chunk=1024))(j, key)
    # replay update_occ_grid's draws from the same key
    n_cells = res ** 3
    k, cells = key, None
    if not all_cells:
        k, sub = jax.random.split(k)
        cells = jax.random.randint(sub, (levels, n_cells // 4), 0, n_cells,
                                   jnp.int32)
        shape = cells.shape
    else:
        shape = (levels, n_cells)
    k, sub = jax.random.split(k)
    jitter = np.array(jax.random.uniform(sub, (*shape, 3)))
    got = tocc.update_occ_grid(
        t, lambda x: _density_np(x, torch), all_cells=all_cells,
        jitter=torch.from_numpy(jitter),
        cells=None if cells is None else torch.from_numpy(np.array(cells)),
        chunk=1000)
    np.testing.assert_array_equal(got.binaries.numpy(),
                                  np.asarray(want.binaries))
    np.testing.assert_allclose(got.occs.numpy(), np.asarray(want.occs),
                               rtol=1e-6)
    assert 0 < got.binaries.float().mean() < 1


@pytest.mark.parametrize("levels,dilate", [(1, 1), (2, 1), (3, 2)])
def test_pooled_binaries_exact(levels, dilate):
    res = 16
    rng = np.random.default_rng(levels)
    bins = rng.uniform(size=(levels, res, res, res)) < 0.03
    j = jocc.create_occ_grid(ROI, res, levels)._replace(
        binaries=jnp.asarray(bins))
    t = tocc.create_occ_grid(ROI, res, levels, device="cpu")._replace(
        binaries=torch.from_numpy(bins))
    want = np.asarray(jocc.pooled_binaries(j, pool=4, dilate=dilate))
    got = tocc.pooled_binaries(t, pool=4, dilate=dilate).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("levels", [1, 2])
def test_lookups_exact(levels):
    res = 16
    rng = np.random.default_rng(10 + levels)
    bins = rng.uniform(size=(levels, res, res, res)) < 0.3
    j = jocc.create_occ_grid(ROI, res, levels)._replace(
        binaries=jnp.asarray(bins))
    t = tocc.create_occ_grid(ROI, res, levels, device="cpu")._replace(
        binaries=torch.from_numpy(bins))
    pos = rng.uniform(-3.5, 3.5, (64, 33, 3)).astype(np.float32)
    # points exactly on cell faces of every level
    edge = (rng.integers(-res, res + 1, (256, 3)) * 3.0 / res).astype(
        np.float32)
    for p in (pos, edge):
        np.testing.assert_array_equal(
            tocc.occupancy_lookup(t, torch.from_numpy(p)).numpy(),
            np.asarray(jocc.occupancy_lookup(j, jnp.asarray(p))))
        coarse_j = jocc.pooled_binaries(j, pool=4, dilate=1)
        coarse_t = tocc.pooled_binaries(t, pool=4, dilate=1)
        np.testing.assert_array_equal(
            tocc.coarse_lookup(t, coarse_t, torch.from_numpy(p)).numpy(),
            np.asarray(jocc.coarse_lookup(j, coarse_j, jnp.asarray(p))))


def test_ray_aabb_intersect_matches():
    rng = np.random.default_rng(3)
    o = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d[:10, 0] = 0.0                      # axis-parallel rays
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    aabb = np.asarray(ROI, np.float32)
    want = jocc.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(aabb))
    got = tocc.ray_aabb_intersect(torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(aabb))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
