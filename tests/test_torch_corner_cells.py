"""The plain versions of K5 (fused_encode_fwd), K1 (interp_fwd), K6
(fused_encode_bwd) and K2 (interp_bwd_fused) on the points that stress the
CUDA kernels' corner addressing, against the JAX Pallas kernels they
replace, run in interpret mode on the CPU; the ray-major sample builder
that chip_smoke.py times the kernels on; and the groups in which K6's and
K2's table gradient is summed (one kernel body, then table_reduce).

The points (cednerf_torch.utils.bench.cell_points): every one of the 27
intra cells of random bricks, and cell and brick boundaries with their f32
neighbours on both sides, on every level of a small L4 F4 spec (one dense,
three hashed levels), padded with uniform points to the JAX tile. Rows come
from the jitted JAX geometry, as the package computes them (see
test_torch_brick_grid.py on FMA contraction).

Tolerances, as tests/test_torch_encode_kernels.py and
tests/test_torch_encode_backward.py hold these functions:
  * K5 and K1, f32 compute and output on bf16-valued tables: rtol 1e-5,
    atol 1e-9 at the +-1e-4 table scale (summation order only);
  * K6 and K2 with compute_dtype=float32 on the JAX side: each level's
    table gradient and d_x within rtol 1e-5 plus 1e-5 of the largest entry
    (f32 summation order only). K2 takes the rows gathered from one
    bf16-valued table at the points' rows, as the K1 forward saves them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.ops import brick_grid as jbg
from cednerf_tpu.ops import pallas_encoder as jpe
from cednerf_tpu.ops import pallas_fused as jpf
from cednerf_torch.ops import brick_grid as tbg
from cednerf_torch.ops import encode_kernels as ek
from cednerf_torch.utils.bench import cell_points, ray_major_samples

SPEC_KW = dict(n_levels=4, n_features=4, base_res=16, max_res=128,
               log2_hashmap_size=14, max_table_rows=512)
TILE = 256


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _case(seed, n_feat=4):
    spec = tbg.BrickGridSpec(**dict(SPEC_KW, n_features=n_feat))
    lay = spec.level_layout()
    assert [l["hashed"] for l in lay] == [False, True, True, True]
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    rng = np.random.default_rng(seed)
    pts = cell_points(scales, nbs, seed)
    pad = -len(pts) % TILE + TILE
    x = np.concatenate([pts, rng.uniform(-0.05, 1.05, (pad, 3))]).astype(
        np.float32)
    rows = np.stack([np.asarray(jax.jit(functools.partial(
        jbg._level_geom, scale=scales[i], nb=nbs[i], hashed=l["hashed"],
        n_rows=l["rows"]))(jnp.asarray(x))[0]) for i, l in enumerate(lay)])
    return lay, scales, nbs, x, rows, rng


def test_cell_points_visit_every_cell_and_boundary():
    spec = tbg.BrickGridSpec(**SPEC_KW)
    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    x = torch.from_numpy(cell_points(scales, nbs, 0))
    for s, nb in zip(scales, nbs):
        cell_raw, _, intra, frac = ek.cell_geom(x, s, nb)
        seen = set(map(tuple, intra.tolist()))
        assert len(seen) == 27, s
        # points on a boundary: frac 0 (and their neighbours just below it)
        assert bool((frac == 0).any()) and bool((frac > 0.99).any())
        hi = 3 * nb - 1
        brick_edge = (cell_raw % 3 == 0) & (cell_raw >= 0) & (cell_raw <= hi)
        assert bool((brick_edge & (frac == 0)).any())


def test_k5_plain_matches_jax_on_corner_cells():
    lay, scales, nbs, x, rows, rng = _case(0)
    tables = [_bf16(rng.uniform(-1e-4, 1e-4, (l["rows"], 256)))
              for l in lay]
    want = jpf.fused_encode_fwd(
        jnp.asarray(x), [jnp.asarray(t) for t in tables], jnp.asarray(rows),
        scales, nbs, 4, compute_dtype=jnp.float32, out_dtype=jnp.float32,
        tile=TILE, depth=4, interpret=True)
    got = ek.fused_encode_fwd(
        torch.from_numpy(x), torch.from_numpy(np.concatenate(tables)),
        torch.from_numpy(rows), scales, nbs, [l["rows"] for l in lay], 4,
        out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-9)


@pytest.mark.parametrize("n_feat", [4, 2, 1])
def test_k1_plain_matches_jax_on_corner_cells(n_feat):
    """K1's plain version on the rows gathered at the cell points, N padded
    to the JAX kernel's tile (interp_fwd takes n % tile == 0 only)."""
    lay, scales, nbs, x, rows, rng = _case(20 + n_feat, n_feat)
    assert len(x) % TILE == 0
    feats = np.stack([_bf16(rng.uniform(-1e-4, 1e-4, (l["rows"],
                                                      64 * n_feat)))[r]
                      for l, r in zip(lay, rows)])
    want = jpe.interp_fwd(jnp.asarray(x), [jnp.asarray(f) for f in feats],
                          scales, nbs, n_feat, compute_dtype=jnp.float32,
                          tile=TILE, interpret=True)
    got = ek.interp_fwd_plain(torch.from_numpy(x), torch.from_numpy(feats),
                              scales, nbs, n_feat, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-9)


@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_k6_plain_matches_jax_on_corner_cells(lvl):
    lay, scales, nbs, x, rows, rng = _case(10 + lvl)
    table = _bf16(rng.uniform(-1, 1, (lay[lvl]["rows"], 256)))
    g = _bf16(rng.normal(size=(len(x), 4)))
    dt_j, dx_j = jpf.fused_encode_bwd(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(rows[lvl]),
        jnp.asarray(table), scale=scales[lvl], nb=nbs[lvl],
        n_rows=lay[lvl]["rows"], n_feat=4, compute_dtype=jnp.float32,
        tile=TILE, depth=4, interpret=True)
    dt_t, dx_t = ek.fused_encode_bwd(
        torch.from_numpy(x), torch.from_numpy(g).to(torch.bfloat16),
        torch.from_numpy(rows[lvl])[None].to(torch.int32),
        torch.from_numpy(table).to(torch.bfloat16), [scales[lvl]],
        [nbs[lvl]], [lay[lvl]["rows"]], 4)
    for got, want in ((dt_t.numpy(), np.asarray(dt_j, np.float32)),
                      (dx_t.numpy(), np.asarray(dx_j))):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_k2_plain_matches_jax_on_corner_cells(lvl):
    lay, scales, nbs, x, rows, rng = _case(30 + lvl)
    table = _bf16(rng.uniform(-1, 1, (lay[lvl]["rows"], 256)))
    feats = table[rows[lvl]]
    g = _bf16(rng.normal(size=(len(x), 4)))
    dt_j, dx_j = jpe.interp_bwd_fused(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(feats, jnp.bfloat16),
        jnp.asarray(rows[lvl]), scale=scales[lvl], nb=nbs[lvl],
        n_rows=lay[lvl]["rows"], n_feat=4, compute_dtype=jnp.float32,
        tile=TILE, interpret=True)
    dt_t, dx_t = ek.interp_bwd_fused(
        torch.from_numpy(x), torch.from_numpy(g).to(torch.bfloat16),
        torch.from_numpy(feats)[None].to(torch.bfloat16),
        torch.from_numpy(rows[lvl])[None].to(torch.int32), [scales[lvl]],
        [nbs[lvl]], [lay[lvl]["rows"]], 4)
    for got, want in ((dt_t.numpy(), np.asarray(dt_j, np.float32)),
                      (dx_t.numpy(), np.asarray(dx_j))):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_ray_major_samples():
    n_rays, n_samples = 300, 64
    x, t, o, d = ray_major_samples(n_rays, n_samples, seed=3, width=64)
    assert x.shape == (n_rays * n_samples, 3) and x.dtype == np.float32
    assert t.shape == (n_rays, n_samples)
    assert x.min() >= 0.0 and x.max() <= 1.0
    assert np.all(np.diff(t, axis=1) >= 0)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, rtol=1e-5)
    # ray-major: sample k of ray r is o_r + t_rk * d_r (up to the clip into
    # the cube, which moves a point by rounding only)
    on_ray = o[:, None] + t[..., None] * d[:, None]
    np.testing.assert_allclose(x.reshape(n_rays, n_samples, 3), on_ray,
                               atol=1e-5)
    # in front of the camera
    assert np.all(t > 0)
    x2, t2, _, _ = ray_major_samples(n_rays, n_samples, seed=3, width=64)
    assert np.array_equal(x, x2) and np.array_equal(t, t2)


@pytest.mark.parametrize("order", ["ray_major", "one_cell", "random"])
def test_k6_match_groups(order):
    """The groups that K6 and K2 (one kernel body) sum the table gradient
    in: one key a live (sample, level) term, offset_l + its row, a zero
    cotangent's INT_MAX dropped, sorted stably into one run a table row.
    table_reduce_plain over those keys equals fused_encode_bwd_plain's
    table gradient bit for bit (the same terms in ascending sample order),
    and the runs are each level's distinct live rows, counted by a loop
    over the samples (one run a level when every sample lies in one
    cell)."""
    spec = tbg.BrickGridSpec(**SPEC_KW)
    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    rng = np.random.default_rng(5)
    n = 32 * 20 + 7
    if order == "ray_major":
        x = ray_major_samples(n // 16 + 1, 16, seed=5, width=64)[0][:n]
    elif order == "one_cell":
        x = np.full((n, 3), 0.3, np.float32)
    else:
        x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x = torch.from_numpy(x)
    rows = torch.stack([tbg._level_geom(x, s, nb, l["hashed"], l["rows"])[0]
                        for s, nb, l in zip(scales, nbs, lay)])
    g = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    g[rng.uniform(size=n) < 0.25] = 0.0     # unused budget slots
    g = g.to(torch.bfloat16)
    table = torch.from_numpy(_bf16(rng.uniform(-1, 1, (sum(level_rows),
                                                       256))))
    offs = np.cumsum([0] + level_rows)
    live = (g.float().view(n, 4, 4) != 0).any(-1).t()          # [L, N]
    keys = torch.where(live, rows + torch.tensor(offs[:-1])[:, None],
                       torch.iinfo(torch.int32).max).to(torch.int32)
    want = ek.fused_encode_bwd_plain(x, g, rows, table.to(torch.bfloat16),
                                     scales, nbs, level_rows, 4)[0]
    got = ek.table_reduce(keys, x, g, scales, nbs, 4,
                          torch.zeros_like(want))[0]
    assert torch.equal(got, want)
    runs = torch.unique_consecutive(torch.sort(keys.reshape(-1),
                                               stable=True)[0])
    runs = runs[runs != torch.iinfo(torch.int32).max]
    for lvl in range(len(scales)):
        distinct = {int(rows[lvl, i]) for i in range(n) if live[lvl, i]}
        in_level = (runs >= offs[lvl]) & (runs < offs[lvl + 1])
        assert int(in_level.sum()) == len(distinct)
        if order == "one_cell":
            assert len(distinct) == 1
