"""Plain versions of the port's brick-encoder kernels K1 and K5 against the
JAX Pallas kernels they replace, run in interpret mode on the CPU.

  * K1: cednerf_torch.ops.encode_kernels.interp_fwd_plain vs
        cednerf_tpu.ops.pallas_encoder.interp_fwd
  * K5: cednerf_torch.ops.encode_kernels.fused_encode_fwd_plain vs
        cednerf_tpu.ops.pallas_fused.fused_encode_fwd

Inputs are drawn with numpy and handed to both sides. Tolerances:
  * f32 lane math: rtol 1e-5, atol 1e-9 at the field's +-1e-4 table scale
    (as tests/test_pallas_encoder.py) -- only the summation order differs;
  * bf16 (the serving dtype): JAX rounds each axis weight, their product and
    each weighted value to bf16 (2^-9 relative each), the port keeps those
    in f32 and rounds the sum once, so a feature may differ by a few bf16
    roundings of the row's largest value: atol 2^-5 * max|row|, rtol 2^-5.
The CUDA kernels themselves are compared with these plain versions on the
card (chip_smoke.py, and tests/test_torch_kernels_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.ops import brick_grid as jbg
from cednerf_tpu.ops.pallas_encoder import interp_fwd as jax_interp_fwd
from cednerf_tpu.ops.pallas_fused import fused_encode_fwd as jax_fused_fwd
from cednerf_torch.ops import brick_grid as tbg
from cednerf_torch.ops import encode_kernels as ek

N = 512


def _setup(seed, n_feat, n=N, levels=4, max_res=128):
    spec = tbg.BrickGridSpec(n_levels=levels, n_features=n_feat, base_res=16,
                             max_res=max_res, log2_hashmap_size=14,
                             max_table_rows=512)
    rng = np.random.default_rng(seed)
    lay = spec.level_layout()
    assert any(l["hashed"] for l in lay) and not all(l["hashed"] for l in lay)
    tables = [rng.uniform(-1e-4, 1e-4, (l["rows"], 64 * n_feat))
              .astype(np.float32) for l in lay]
    x = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    rows = np.stack([np.asarray(jbg._level_geom(
        jnp.asarray(x), scales[i], nbs[i], l["hashed"], l["rows"])[0])
        for i, l in enumerate(lay)])
    return spec, lay, tables, x, scales, nbs, rows


def _bf16_tol(want, vals):
    return 2.0 ** -5 * np.abs(want) + 2.0 ** -5 * np.abs(vals).max()


@pytest.mark.parametrize("n_feat", [2, 4])
def test_interp_plain_matches_pallas_f32(n_feat):
    _, _, tables, x, scales, nbs, rows = _setup(0, n_feat)
    feats = [t[r] for t, r in zip(tables, rows)]
    want = jax_interp_fwd(jnp.asarray(x), [jnp.asarray(f) for f in feats],
                          scales, nbs, n_feat, compute_dtype=jnp.float32,
                          tile=256, interpret=True)
    got = ek.interp_fwd_plain(torch.from_numpy(x),
                              torch.from_numpy(np.stack(feats)), scales, nbs,
                              n_feat, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-9)


def test_interp_plain_matches_pallas_bf16():
    _, _, tables, x, scales, nbs, rows = _setup(1, 4)
    feats = [t[r] for t, r in zip(tables, rows)]
    want = np.asarray(jax_interp_fwd(
        jnp.asarray(x), [jnp.asarray(f, jnp.bfloat16) for f in feats],
        scales, nbs, 4, tile=256, interpret=True), np.float32)
    f16 = torch.from_numpy(np.stack(feats)).to(torch.bfloat16)
    got = ek.interp_fwd_plain(torch.from_numpy(x), f16, scales, nbs, 4)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert np.all(diff <= _bf16_tol(want, np.stack(feats))), diff.max()


def test_fused_plain_matches_pallas_f32():
    _, lay, tables, x, scales, nbs, rows = _setup(2, 4, n=1024)
    # the dma128 kernel reads bf16-valued rows; give both sides those values
    tables = [np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32)
              for t in tables]
    want = jax_fused_fwd(jnp.asarray(x), [jnp.asarray(t) for t in tables],
                         jnp.asarray(rows), scales, nbs, 4,
                         compute_dtype=jnp.float32, out_dtype=jnp.float32,
                         tile=256, depth=4, interpret=True)
    got = ek.fused_encode_fwd_plain(
        torch.from_numpy(x), torch.from_numpy(np.concatenate(tables)),
        torch.from_numpy(rows), scales, nbs, [l["rows"] for l in lay], 4,
        out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-9)


def test_fused_plain_matches_pallas_bf16():
    _, lay, tables, x, scales, nbs, rows = _setup(3, 4, n=1024)
    want = np.asarray(jax_fused_fwd(
        jnp.asarray(x), [jnp.asarray(t) for t in tables], jnp.asarray(rows),
        scales, nbs, 4, tile=256, depth=4, interpret=True), np.float32)
    table = torch.from_numpy(np.concatenate(tables)).to(torch.bfloat16)
    got = ek.fused_encode_fwd(torch.from_numpy(x), table,
                              torch.from_numpy(rows), scales, nbs,
                              [l["rows"] for l in lay], 4)
    diff = np.abs(got.float().numpy() - want)
    assert np.all(diff <= _bf16_tol(want, np.concatenate(tables))), diff.max()


def test_fused_plain_ragged_n_equals_gather_interp():
    """Any N: K5's plain version at a ragged N equals K1's on the gathered
    rows and the first N rows of a longer batch (nothing is tiled)."""
    spec, lay, tables, x, scales, nbs, rows = _setup(4, 4, n=1000)
    level_rows = [l["rows"] for l in lay]
    table = torch.from_numpy(np.concatenate(tables))
    xt, rt = torch.from_numpy(x), torch.from_numpy(rows)
    full = ek.fused_encode_fwd_plain(xt, table, rt, scales, nbs, level_rows,
                                     4, torch.float32)
    part = ek.fused_encode_fwd_plain(xt[:997], table, rt[:, :997].contiguous(),
                                     scales, nbs, level_rows, 4,
                                     torch.float32)
    feats = torch.stack([torch.from_numpy(t)[torch.from_numpy(r).long()]
                         for t, r in zip(tables, rows)])
    k1 = ek.interp_fwd_plain(xt, feats, scales, nbs, 4, torch.float32)
    assert torch.equal(full[:997], part)
    assert torch.equal(full, k1)


def test_fused_plain_clamps_rows_out_of_range():
    """K5 clamps a row index into its level; its plain version does too."""
    _, lay, tables, x, scales, nbs, rows = _setup(6, 4, n=256)
    level_rows = [l["rows"] for l in lay]
    rng = np.random.default_rng(6)
    bad = rows.astype(np.int64)
    for i, r in enumerate(level_rows):
        sel = rng.uniform(size=bad.shape[1]) < 0.3
        bad[i, sel] = rng.choice([-5, -1, r, r + 7], sel.sum())
    clamped = np.clip(bad, 0, np.asarray(level_rows)[:, None] - 1)
    table = torch.from_numpy(np.concatenate(tables))
    xt = torch.from_numpy(x)
    got = ek.fused_encode_fwd_plain(
        xt, table, torch.from_numpy(bad.astype(np.int32)), scales, nbs,
        level_rows, 4, torch.float32)
    want = ek.fused_encode_fwd_plain(
        xt, table, torch.from_numpy(clamped.astype(np.int32)), scales, nbs,
        level_rows, 4, torch.float32)
    assert (bad != clamped).any()
    assert torch.equal(got, want)


def test_wrappers_on_cpu_take_the_plain_version():
    _, lay, tables, x, scales, nbs, rows = _setup(5, 2, n=64)
    ek.reset_counts()
    xt = torch.from_numpy(x)
    table = torch.from_numpy(np.concatenate(tables)).to(torch.bfloat16)
    out = ek.fused_encode_fwd(xt, table, torch.from_numpy(rows), scales, nbs,
                              [l["rows"] for l in lay], 2)
    feats = torch.stack([table[:l["rows"]][:0] for l in lay])
    out1 = ek.interp_fwd(xt[:0], feats, scales, nbs, 2)
    rows_t = torch.from_numpy(rows)
    g = torch.ones((64, 8), dtype=torch.bfloat16)
    level_rows = [l["rows"] for l in lay]
    d_t, d_x = ek.fused_encode_bwd(xt, g, rows_t, table, scales, nbs,
                                   level_rows, 2)
    feats = torch.stack([table[sum(level_rows[:i]):][rows_t[i].long()]
                         for i in range(len(lay))])
    d_t1, _ = ek.interp_bwd_fused(xt, g, feats, rows_t, scales, nbs,
                                  level_rows, 2)
    upd, d_x7 = ek.interp_bwd(xt, g, feats, scales, nbs, 2)
    d_tc, d_xc = ek.fused_encode_bwd_cell(
        xt, g, rows_t, table, scales, nbs, level_rows, 2,
        [-1] * (len(lay) - 1) + [0], torch.bfloat16, False)
    assert d_tc.shape == (sum(level_rows), 128)
    assert d_tc[sum(level_rows[:-1]):].any()
    torch.testing.assert_close(d_xc, d_x)
    assert out.shape == (64, 8) and out.dtype == torch.bfloat16
    assert out1.shape == (0, 8)
    assert d_t.shape == (sum(level_rows), 128) and d_x.shape == (64, 3)
    torch.testing.assert_close(d_t1, d_t)
    assert upd.shape == (len(lay), 64, 128) and upd.dtype == torch.float32
    torch.testing.assert_close(d_x7, d_x)
    names = {"interp_fwd", "fused_encode_fwd", "fused_encode_bwd",
             "fused_encode_bwd_cell", "fold_cells", "interp_bwd_fused",
             "interp_bwd", "table_reduce", "table_carry"}
    assert ek.launches == dict.fromkeys(names, 0)
    assert ek.plain_cuda_calls == dict.fromkeys(names, 0)
