"""K7 (`interp_bwd`, the all-levels backward as update rows) of the port
against the JAX package's Pallas `interp_bwd` run in interpret mode, and the
encoder probe tool on the CPU.

  * the plain version's update rows [L, N, 64F] and d_x against JAX's, for
    n_feat 4 and 2, one dense and two hashed levels, compute_dtype float32
    and bfloat16, upd_dtype float32 and bfloat16, on points that sit on cell
    boundaries and just outside the unit cube (the edge gate of d_x);
  * its rows scattered per level by K3's plain version against K2's plain
    table gradient and against JAX's `.at[rows].add` of its own rows;
  * cednerf_torch.tools.profile_interp_enc.run on the CPU at a small spec.

N is ragged on the port side (500); the JAX kernel needs N % tile == 0, so
its inputs are padded to 512 and its outputs cut back.

Tolerances. With compute_dtype=float32 the JAX kernel forms the same f32
products in the same order (rows equal to rounding), and its d_x sums 64F
lanes in another order: rtol 1e-5 with atol 1e-5 of each array's largest
entry. With compute_dtype=bfloat16 JAX rounds the fractions, the lane
weights and their products to bf16 where the port keeps them in f32:
2^-6 of the largest entry (as tests/test_torch_encode_backward.py).
upd_dtype=bfloat16 rounds the f32 product once on both sides. Scattered
rows against K2's plain table gradient: the same f32 adds in the same
order, rtol 1e-6; against JAX's f32 scatter: rtol 1e-5 with atol 1e-5 of
the largest entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.ops import brick_grid as jbg
from cednerf_tpu.ops import pallas_encoder as jpe
from cednerf_torch.ops import brick_grid as tbg
from cednerf_torch.ops import encode_kernels as ek
from cednerf_torch.ops import scatter_kernels as sk
from cednerf_torch.tools import profile_interp_enc as pie

SPEC_KW = dict(n_levels=3, n_features=4, base_res=16, max_res=64,
               log2_hashmap_size=12, max_table_rows=256)
N, N_PAD, TILE = 500, 512, 256
BF16_FRAC = 2.0 ** -6


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _positions(rng, scales, n):
    """n points: on cell boundaries of every level (k - 0.5) / scale for k
    in [-1, scale + 1], and their f32 neighbours; 24 with one coordinate in
    [1.1, 1.25], past every level's last cell; the rest uniform in
    [-0.05, 1.05]^3."""
    pts = []
    per = n // (4 * len(scales) * 3)
    for s in scales:
        s32 = np.float32(s)
        k = rng.integers(-1, int(s) + 2, (per, 3)).astype(np.float32)
        xb = ((k - np.float32(0.5)) / s32).astype(np.float32)
        pts += [xb, np.nextafter(xb, np.float32(2)),
                np.nextafter(xb, np.float32(-2))]
    pts = np.concatenate(pts)
    rest = rng.uniform(-0.05, 1.05, (n - len(pts), 3))
    rest[np.arange(24), np.arange(24) % 3] = rng.uniform(1.1, 1.25, 24)
    return np.concatenate([pts, rest]).astype(np.float32)


def _case(seed, n_feat):
    """x [N, 3], g [N, L*F] (bf16 values), per level the JAX rows and the
    gathered bf16 rows, with the spec's scales, nbs and row counts."""
    spec = tbg.BrickGridSpec(**{**SPEC_KW, "n_features": n_feat})
    lay = spec.level_layout()
    assert [l["hashed"] for l in lay] == [False, True, True]
    scales = spec.level_scales()
    rng = np.random.default_rng(seed)
    x = _positions(rng, scales, N)
    g = _bf16(rng.normal(size=(N, spec.output_dim)))
    rows, feats = [], []
    for l, lay_l in enumerate(lay):
        geom = jax.jit(functools.partial(
            jbg._level_geom, scale=scales[l], nb=lay_l["n_bricks_axis"],
            hashed=lay_l["hashed"], n_rows=lay_l["rows"]))
        r = np.asarray(geom(jnp.asarray(x))[0])
        table = _bf16(rng.uniform(-1, 1, (lay_l["rows"], 64 * n_feat)))
        rows.append(r)
        feats.append(table[r])
    return dict(x=x, g=g, rows=rows, feats=feats, scales=scales,
                nbs=[l["n_bricks_axis"] for l in lay],
                level_rows=[l["rows"] for l in lay], n_feat=n_feat)


def _jax_k7(c, compute_dtype, upd_dtype):
    pad = N_PAD - N
    x = np.concatenate([c["x"], np.full((pad, 3), 0.5, np.float32)])
    g = np.concatenate([c["g"], np.zeros((pad, c["g"].shape[1]), np.float32)])
    feats = [jnp.asarray(np.concatenate(
        [f, np.zeros((pad, f.shape[1]), np.float32)]), jnp.bfloat16)
        for f in c["feats"]]
    upds, d_x = jpe.interp_bwd(
        jnp.asarray(x), jnp.asarray(g, jnp.bfloat16), feats, c["scales"],
        c["nbs"], c["n_feat"], compute_dtype=compute_dtype,
        upd_dtype=upd_dtype, tile=TILE, interpret=True)
    return ([np.asarray(u.astype(jnp.float32))[:N] for u in upds],
            np.asarray(d_x)[:N])


def _port_k7(c, upd_dtype):
    return ek.interp_bwd(
        torch.from_numpy(c["x"]), torch.from_numpy(c["g"]).to(torch.bfloat16),
        torch.from_numpy(np.stack(c["feats"])).to(torch.bfloat16),
        c["scales"], c["nbs"], c["n_feat"], upd_dtype=upd_dtype)


def _close_to_scale(got, want, frac, rtol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert scale > 0, name
    np.testing.assert_allclose(got, want, rtol=rtol, atol=frac * scale,
                               err_msg=name)


@pytest.mark.parametrize("n_feat,compute,upd_dtype", [
    (4, "float32", "float32"), (4, "bfloat16", "float32"),
    (2, "float32", "float32"), (2, "bfloat16", "float32"),
    (4, "float32", "bfloat16"), (2, "bfloat16", "bfloat16")])
def test_k7_plain_matches_jax_kernel(n_feat, compute, upd_dtype):
    c = _case(n_feat * 10 + len(compute), n_feat)
    want_u, want_x = _jax_k7(c, jnp.dtype(compute), jnp.dtype(upd_dtype))
    upd, d_x = _port_k7(c, getattr(torch, upd_dtype))
    assert upd.dtype == getattr(torch, upd_dtype) and d_x.dtype == torch.float32
    assert upd.shape == (3, N, 64 * n_feat) and d_x.shape == (N, 3)
    frac, rtol = (1e-5, 1e-5) if compute == "float32" else (BF16_FRAC, 0.0)
    for l in range(3):
        u = upd[l].float().numpy()
        # only the 8 corners of each sample's cell carry weight
        assert ((u != 0).sum(1) <= 8 * n_feat).all()
        _close_to_scale(u, want_u[l], frac, rtol, f"upd level {l}")
    _close_to_scale(d_x.numpy(), want_x, frac, rtol, "d_x")
    # the edge gate: an axis whose cell every level clamped has no d_x
    xt = torch.from_numpy(c["x"])
    gated = np.all([tbg._level_geom(xt, s, nb, False, 1)[3].numpy() == 0
                    for s, nb in zip(c["scales"], c["nbs"])], axis=0)
    assert (gated & (c["x"] < 0)).any() and (gated & (c["x"] > 1)).any()
    assert (d_x.numpy()[gated] == 0).all()


def test_k7_rows_scattered_by_k3_match_k2_and_jax():
    c = _case(7, 4)
    upd, d_x = _port_k7(c, torch.float32)
    rows = torch.from_numpy(np.stack(c["rows"])).to(torch.int32)
    d_k2, dx_k2 = ek.interp_bwd_fused(
        torch.from_numpy(c["x"]), torch.from_numpy(c["g"]).to(torch.bfloat16),
        torch.from_numpy(np.stack(c["feats"])).to(torch.bfloat16), rows,
        c["scales"], c["nbs"], c["level_rows"], 4)
    torch.testing.assert_close(d_x, dx_k2, rtol=1e-6, atol=1e-6)
    want_u, _ = _jax_k7(c, jnp.float32, jnp.float32)
    for l, d_l in enumerate(d_k2.split(c["level_rows"])):
        got = sk.scatter_add_rows(rows[l], upd[l], c["level_rows"][l])
        torch.testing.assert_close(got, d_l, rtol=1e-6,
                                   atol=1e-6 * d_l.abs().max().item())
        want = jnp.zeros((c["level_rows"][l], 256), jnp.float32).at[
            jnp.asarray(c["rows"][l])].add(jnp.asarray(want_u[l]))
        _close_to_scale(got.numpy(), np.asarray(want), 1e-5, 1e-5,
                        f"table gradient level {l}")


def test_profile_interp_enc_runs_on_cpu():
    res = pie.run(512, SPEC_KW, device="cpu", seed=3)
    assert res["ok"] and res["ms"] is None
    assert res["layouts"] == [[216, False], [256, True], [256, True]]
    assert res["fwd_scale"] > 0
    assert res["fwd_max_abs_err"] <= pie.FWD_FRAC * res["fwd_scale"]
    assert max(res["d_table_rel_err"].values()) <= pie.TABLE_FRAC
    assert res["dx_rel_err"] <= pie.DX_FRAC
