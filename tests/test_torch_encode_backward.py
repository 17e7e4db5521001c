"""The port's brick-encoder backward against the JAX package's.

  * the plain versions of K6 (fused_encode_bwd) and K2 (interp_bwd_fused)
    against the JAX kernels run in interpret mode, one level at a time,
    dense and hashed;
  * brick_encode's gradients (every table and x) against jax.grad of the
    JAX brick_encode, through XLA autodiff (use_custom_vjp=False) and
    through the JAX Pallas route (interp_impl="pallas");
  * the dense-level gradient through _materialize_dense_bricks, the
    grad_accum_dtype rounding, and trunc_exp's backward.

Tolerances. The JAX kernels form the lane weights and the products in
bf16 and sum in f32; the port keeps weights and products in f32. Against
them each gradient is held to 2^-6 of its largest entry (observed: ~0.5%).
With compute_dtype=float32 on both sides the functions are the same up to
f32 summation order: rtol 1e-5 with atol 1e-5 of the largest entry. The
JAX geometry is jitted, as the package runs it (see
test_torch_brick_grid.py on FMA contraction).
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
from cednerf_tpu.utils.math import trunc_exp as j_trunc_exp
from cednerf_torch.ops import brick_grid as tbg
from cednerf_torch.ops import encode_kernels as ek
from cednerf_torch.utils.math import trunc_exp

SPEC_KW = dict(n_levels=3, n_features=4, base_res=16, max_res=64,
               log2_hashmap_size=12, max_table_rows=256)
BF16_FRAC = 2.0 ** -6


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _close_to_scale(got, want, frac, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= frac * scale + 1e-30, f"{name}: err {err} scale {scale}"


def _positions(seed, scales, n, inside=False):
    """n points: a quarter on cell boundaries of every level (and their f32
    neighbours), the rest uniform in and just around the unit cube (with
    inside=True, all in [0, 1]^3, where no level clamps a cell)."""
    rng = np.random.default_rng(seed)
    pts = []
    per = n // (4 * len(scales) * 3)
    for s in scales:
        s32 = np.float32(s)
        k = rng.integers(-1, int(s) + 2, (per, 3)).astype(np.float32)
        xb = ((k - np.float32(0.5)) / s32).astype(np.float32)
        pts += [xb, np.nextafter(xb, np.float32(2)),
                np.nextafter(xb, np.float32(-2))]
    pts = np.concatenate(pts)
    lo, hi = (0.0, 1.0) if inside else (-0.05, 1.05)
    if inside:
        pts = np.clip(pts, 0.0, 1.0)
    rest = rng.uniform(lo, hi, (n - len(pts), 3)).astype(np.float32)
    return np.concatenate([pts, rest]).astype(np.float32)


def _level_case(seed, lvl, n, n_feat):
    spec = tbg.BrickGridSpec(**{**SPEC_KW, "n_features": n_feat})
    lay = spec.level_layout()[lvl]
    scale = spec.level_scales()[lvl]
    rng = np.random.default_rng(seed)
    x = _positions(seed, [scale], n)
    table = _bf16(rng.uniform(-1, 1, (lay["rows"], 64 * n_feat)))
    g = _bf16(rng.normal(size=(n, n_feat)))
    geom = jax.jit(functools.partial(
        jbg._level_geom, scale=scale, nb=lay["n_bricks_axis"],
        hashed=lay["hashed"], n_rows=lay["rows"]))
    rows = np.asarray(geom(jnp.asarray(x))[0])
    return x, table, g, rows, scale, lay


@pytest.mark.parametrize("lvl", [0, 2], ids=["dense", "hashed"])
def test_k6_plain_matches_jax_kernel(lvl):
    x, table, g, rows, scale, lay = _level_case(lvl, lvl, 512, 4)
    assert lay["hashed"] == (lvl == 2)
    dt_j, dx_j = jpf.fused_encode_bwd(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(rows), jnp.asarray(table),
        scale=scale, nb=lay["n_bricks_axis"], n_rows=lay["rows"], n_feat=4,
        tile=256, depth=4, interpret=True)
    dt_t, dx_t = ek.fused_encode_bwd(
        torch.from_numpy(x), torch.from_numpy(g),
        torch.from_numpy(rows)[None].to(torch.int32),
        torch.from_numpy(table).to(torch.bfloat16), [scale],
        [lay["n_bricks_axis"]], [lay["rows"]], 4)
    assert dt_t.dtype == torch.float32 and dx_t.shape == (512, 3)
    _close_to_scale(dt_t.numpy(), np.asarray(dt_j, np.float32), BF16_FRAC,
                    "d_table")
    _close_to_scale(dx_t.numpy(), np.asarray(dx_j), BF16_FRAC, "d_x")


@pytest.mark.parametrize("lvl,n_feat", [(0, 4), (2, 4), (1, 2)])
def test_k2_plain_matches_jax_kernel(lvl, n_feat):
    x, table, g, rows, scale, lay = _level_case(10 + lvl, lvl, 512, n_feat)
    feats = table[rows]
    dt_j, dx_j = jpe.interp_bwd_fused(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(feats, jnp.bfloat16),
        jnp.asarray(rows), scale=scale, nb=lay["n_bricks_axis"],
        n_rows=lay["rows"], n_feat=n_feat, tile=256, interpret=True)
    dt_t, dx_t = ek.interp_bwd_fused(
        torch.from_numpy(x), torch.from_numpy(g),
        torch.from_numpy(feats)[None].to(torch.bfloat16),
        torch.from_numpy(rows)[None].to(torch.int32), [scale],
        [lay["n_bricks_axis"]], [lay["rows"]], n_feat)
    _close_to_scale(dt_t.numpy(), np.asarray(dt_j, np.float32), BF16_FRAC,
                    "d_table")
    _close_to_scale(dx_t.numpy(), np.asarray(dx_j), BF16_FRAC, "d_x")


def test_k2_and_k6_plain_agree_on_all_levels():
    """Both plain backward routes give the same gradients (the rows K2 saves
    are the rows K6 re-gathers) and clamp out-of-range rows alike."""
    spec = tbg.BrickGridSpec(**SPEC_KW)
    lay = spec.level_layout()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_positions(5, spec.level_scales(), 700))
    level_rows = [l["rows"] for l in lay]
    table = torch.from_numpy(rng.uniform(-1, 1, (sum(level_rows), 256))
                             .astype(np.float32)).to(torch.bfloat16)
    rows = torch.stack([tbg._level_geom(x, spec.level_scales()[i],
                                        l["n_bricks_axis"], l["hashed"],
                                        l["rows"])[0]
                        for i, l in enumerate(lay)])
    g = torch.from_numpy(rng.normal(size=(700, 12)).astype(
        np.float32)).to(torch.bfloat16)
    offs = np.cumsum([0] + level_rows)
    feats = torch.stack([table[offs[i]:offs[i + 1]][rows[i].long()]
                         for i in range(3)])
    nbs = [l["n_bricks_axis"] for l in lay]
    a = ek.fused_encode_bwd(x, g, rows, table, spec.level_scales(), nbs,
                            level_rows, 4)
    b = ek.interp_bwd_fused(x, g, feats, rows, spec.level_scales(), nbs,
                            level_rows, 4)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6)


def _grad_case(seed, n, spec_kw, inside=False):
    rng = np.random.default_rng(seed)
    jspec = jbg.BrickGridSpec(**spec_kw)
    x = _positions(seed, tbg.BrickGridSpec(**spec_kw).level_scales(), n,
                   inside)
    params = {name: rng.uniform(-1, 1, shape).astype(np.float32)
              for name, shape in jspec.param_shapes()}
    g = rng.normal(size=(n, jspec.output_dim)).astype(np.float32)
    return jspec, x, params, g


def _port_grads(spec_kw, x, params, g, dtype):
    tspec = tbg.BrickGridSpec(**spec_kw)
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    out = tbg.brick_encode(xt, pt, tspec, compute_dtype=dtype)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return xt.grad.numpy(), {k: v.grad.numpy() for k, v in pt.items()}


def _jax_grads(jspec, x, params, g, dtype, **kw):
    def f(xx, pp):
        out = jbg.brick_encode(xx, pp, jspec, compute_dtype=dtype, **kw)
        return jnp.sum(out.astype(jnp.float32) * g)

    gx, gp = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    return np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}


@pytest.mark.parametrize("route", ["autodiff", "pallas"])
@pytest.mark.parametrize("interp_impl", ["xla", "interp"])
def test_brick_encode_grads_match_jax_f32(route, interp_impl):
    """XLA autodiff has no edge gate on d_x (it differentiates the clamped
    cell's fraction), so its case keeps every point inside the cube; the
    Pallas route gates as the port does and takes points outside too."""
    kw = {**SPEC_KW, "grad_accum_dtype": "float32"}
    jspec, x, params, g = _grad_case(1, 2048, kw, inside=route == "autodiff")
    if route == "pallas":
        jspec = jbg.BrickGridSpec(**{**kw, "interp_impl": "pallas"})
        assert jbg._pallas_route_ok(jspec, 2048, jspec.level_layout())
        want = _jax_grads(jspec, x, params, g, jnp.float32)
    else:
        want = _jax_grads(jspec, x, params, g, jnp.float32,
                          use_custom_vjp=False)
    got = _port_grads({**kw, "interp_impl": interp_impl}, x, params, g,
                      torch.float32)
    assert {k for k in got[1]} == {"grid_0", "bricks_1", "bricks_2"}
    _close_to_scale(got[0], want[0], 1e-5, "d_x")
    for k in want[1]:
        np.testing.assert_allclose(
            got[1][k], want[1][k], rtol=1e-5,
            atol=1e-5 * np.abs(want[1][k]).max(), err_msg=k)


def test_brick_encode_grads_match_jax_bf16():
    """The serving/training dtype: bf16 tables and output on both sides."""
    kw = {**SPEC_KW, "grad_accum_dtype": "float32"}
    jspec, x, params, g = _grad_case(2, 1024, kw)
    want = _jax_grads(jbg.BrickGridSpec(**{**kw, "interp_impl": "pallas"}),
                      x, params, g, jnp.bfloat16)
    got = _port_grads(kw, x, params, g, torch.bfloat16)
    _close_to_scale(got[0], want[0], BF16_FRAC, "d_x")
    for k in want[1]:
        _close_to_scale(got[1][k], want[1][k], BF16_FRAC, k)


def test_bf16_accumulator_rounds_the_finished_sum_once():
    kw = {**SPEC_KW, "grad_accum_dtype": "float32"}
    _, x, params, g = _grad_case(3, 1024, kw)
    _, g32 = _port_grads(kw, x, params, g, torch.bfloat16)
    _, g16 = _port_grads({**kw, "grad_accum_dtype": "bfloat16"}, x, params,
                         g, torch.bfloat16)
    for k in ("bricks_1", "bricks_2"):
        want = torch.from_numpy(g32[k]).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(g16[k], want, err_msg=k)
        assert g16[k].dtype == np.float32


def test_dense_brick_corners_sum_their_gradients():
    """A corner shared by neighbouring bricks (index 3k, 0 < k < nb, on an
    axis) collects the gradient of every brick that holds it."""
    nb = 3
    grid = torch.zeros((3 * nb + 1,) * 3 + (2,), requires_grad=True)
    tbg._materialize_dense_bricks(grid, nb).sum().backward()
    per_axis = np.ones(3 * nb + 1)
    per_axis[3:3 * nb:3] = 2
    want = per_axis[:, None, None] * per_axis[None, :, None] \
        * per_axis[None, None, :]
    np.testing.assert_array_equal(grid.grad[..., 0].numpy(), want)
    np.testing.assert_array_equal(grid.grad[..., 1].numpy(), want)


def test_trunc_exp_matches_jax():
    x = np.linspace(-5, 40, 91).astype(np.float32)
    g = np.linspace(0.5, 2, 91).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = trunc_exp(xt)
    (y * torch.from_numpy(g)).sum().backward()
    want_y, vjp = jax.vjp(j_trunc_exp, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-6)
    assert np.isfinite(xt.grad.numpy()).all()
    np.testing.assert_allclose(xt.grad.numpy()[x > 15],
                               (g * np.exp(np.float32(15)))[x > 15],
                               rtol=1e-6)
