"""cednerf_torch/ops/brick_grid.py against cednerf_tpu/ops/brick_grid.py.

Integer outputs (brick rows, intra-brick cells, edge flags, materialized
dense bricks) must be equal exactly; brick_encode is compared in f32 (rtol
1e-5, summation order only) and in bf16 (the serving dtype; see the bf16
tolerance note in test_torch_encode_kernels.py).

The JAX geometry is run under jax.jit, as the package runs it: XLA then
contracts pos = x*scale + 0.5 into one FMA, which the port reproduces (its
plain version and kernels round pos once). Run op by op, JAX rounds twice
and its fractions differ from its own jitted ones by an ulp of pos.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.ops import brick_grid as jbg
from cednerf_torch.ops import brick_grid as tbg

SPEC_KW = dict(n_levels=4, n_features=4, base_res=16, max_res=128,
               log2_hashmap_size=14, max_table_rows=512)


def _jspec(**kw):
    return jbg.BrickGridSpec(**{**SPEC_KW, **kw})


def _tspec(**kw):
    return tbg.BrickGridSpec(**{**SPEC_KW, **kw})


def _positions(seed, scales, n=3000):
    """Uniform points in and around the unit cube plus points that land
    exactly on cell boundaries of every level (and their f32 neighbours)."""
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(-0.3, 1.3, (n, 3)).astype(np.float32)]
    for s in scales:
        s32 = np.float32(s)
        k = rng.integers(-2, int(s) + 3, (256, 3)).astype(np.float32)
        xb = ((k - np.float32(0.5)) / s32).astype(np.float32)
        pts += [xb, np.nextafter(xb, np.float32(2)),
                np.nextafter(xb, np.float32(-2))]
    return np.concatenate(pts).astype(np.float32)


def test_layout_and_param_shapes_match():
    for kw in ({}, {"fine_table_rows": 1024, "fine_from_level": 2},
               {"n_levels": 8, "max_res": 1024, "log2_hashmap_size": 21,
                "max_table_rows": 16384}):
        assert _tspec(**kw).level_layout() == _jspec(**kw).level_layout()
        assert _tspec(**kw).param_shapes() == _jspec(**kw).param_shapes()


def test_level_geom_exact():
    spec = _tspec()
    lay = spec.level_layout()
    assert {l["hashed"] for l in lay} == {True, False}
    x = _positions(0, spec.level_scales())
    for lvl, l in enumerate(lay):
        args = (spec.level_scales()[lvl], l["n_bricks_axis"], l["hashed"],
                l["rows"])
        jfn = jax.jit(functools.partial(jbg._level_geom, scale=args[0],
                                        nb=args[1], hashed=args[2],
                                        n_rows=args[3]))
        want = [np.asarray(a) for a in jfn(jnp.asarray(x))]
        got = [a.numpy() for a in tbg._level_geom(torch.from_numpy(x), *args)]
        for name, w, g in zip(("rows", "intra", "frac", "ok"), want, got):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=f"{name} lvl {lvl}")


def test_level_geom_hash_wraps_in_uint32():
    """Brick coordinates whose prime products overflow 32 bits."""
    x = np.asarray([[0.999, 0.999, 0.999], [0.5, 0.999, 0.01],
                    [0.01, 0.73, 0.999]], np.float32)
    scale, nb, n_rows = 4095.0, 1366, 16384
    want = np.asarray(jbg._level_geom(jnp.asarray(x), scale, nb, True,
                                      n_rows)[0])
    got = tbg._level_geom(torch.from_numpy(x), scale, nb, True, n_rows)[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nb,f", [(1, 1), (3, 4), (6, 2)])
def test_materialize_dense_bricks_exact(nb, f):
    n = 3 * nb + 1
    grid = np.random.default_rng(nb).normal(size=(n, n, n, f)).astype(
        np.float32)
    want = np.asarray(jbg._materialize_dense_bricks(jnp.asarray(grid), nb))
    got = tbg._materialize_dense_bricks(torch.from_numpy(grid), nb).numpy()
    np.testing.assert_array_equal(got, want)


def _params(seed, spec):
    rng = np.random.default_rng(seed)
    return {name: rng.uniform(-1e-4, 1e-4, shape).astype(np.float32)
            for name, shape in spec.param_shapes()}


@pytest.mark.parametrize("interp_impl", ["xla", "interp"])
def test_brick_encode_matches_jax_f32(interp_impl):
    jspec, tspec = _jspec(), _tspec(interp_impl=interp_impl)
    params = _params(1, jspec)
    x = _positions(1, tspec.level_scales(), n=1000)
    want = jax.jit(lambda p, x: jbg.brick_encode(
        x, p, jspec, compute_dtype=jnp.float32))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    with torch.no_grad():
        got = tbg.brick_encode(torch.from_numpy(x),
                               {k: torch.from_numpy(v)
                                for k, v in params.items()},
                               tspec, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-9)


def test_brick_encode_matches_jax_bf16():
    jspec, tspec = _jspec(), _tspec()
    params = _params(2, jspec)
    x = _positions(2, tspec.level_scales(), n=1000)
    want = np.asarray(jax.jit(lambda p, x: jbg.brick_encode(x, p, jspec))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)),
        np.float32)
    with torch.no_grad():
        got = tbg.brick_encode(torch.from_numpy(x),
                               {k: torch.from_numpy(v)
                                for k, v in params.items()}, tspec)
    assert got.dtype == torch.bfloat16
    tol = 2.0 ** -5 * np.abs(want) + 2.0 ** -5 * 1e-4
    assert np.all(np.abs(got.float().numpy() - want) <= tol)


def test_brick_encode_unported_options_raise():
    spec = _tspec()
    params = {k: torch.from_numpy(v) for k, v in _params(3, spec).items()}
    x = torch.rand(8, 3)
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="row_layout"):
            tbg.brick_encode(x, params, dataclasses.replace(
                spec, row_layout="cell"))
        with pytest.raises(NotImplementedError, match="keyframe"):
            tbg.brick_encode(x, params, dataclasses.replace(
                spec, time_keyframes=4), t=torch.rand(8, 1))
    with pytest.raises(NotImplementedError, match="backward"):
        tbg.brick_encode(x.requires_grad_(), params, spec)
    with torch.no_grad():
        out = tbg.brick_encode(x.detach(), params,
                               dataclasses.replace(spec, interp_impl="plain"))
    assert out.shape == (8, spec.output_dim)
