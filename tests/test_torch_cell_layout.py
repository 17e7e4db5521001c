"""The cell row layouts (`row_layout` cell / cellz / cellfused) and
`remat_feats` of cednerf_torch/ops/brick_grid.py against
cednerf_tpu/ops/brick_grid.py.

  * Which levels take the cell route: JAX's per-level rule.
  * f32 compute, 3D and 4D, every layout: outputs within rtol 1e-5 / atol
    1e-6, d_x, d_t and the table gradients within rtol 1e-4 / atol 1e-5 of
    JAX's same layout (the limits of JAX's own cell tests,
    tests/test_brick_grid.py), jitted as the package runs them; with a
    `cell_rows_cap` that sends some levels back to the brick route.
  * bf16 compute: the JAX cell levels form each term w * g in bf16, sum the
    terms per cell row in f32, round the sums to bf16, fold them onto the
    brick corners (the expansion matmul's transpose) with a bf16 result and
    cast that to the f32 master. The port keeps those points (K6c's plain
    version and fold_cells), so its cell-level gradients equal
    JAX's bit for bit when JAX runs op by op; the brick route's f32
    gradients differ from them by more than a bf16 ulp on a large share of
    entries, which is what shows the rounding was carried over. Under jit
    XLA keeps some of the bf16 products of a fusion in f32 (excess
    precision), so the jitted JAX gradients are not the reference here.
  * fold_cells' plain version against the vjp of JAX's
    `_expand_cell_table`, F 1, 2 and 4, bf16 and f32 accumulators; the cell
    layouts' backward wrapper (K6c and the fold) on CPU tensors against the
    plain versions and the fold as it was written before its kernel.
  * remat_feats: bit-identical outputs and gradients on every route.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.ops import brick_grid as jbg
from cednerf_torch.ops import brick_grid as tbg
from cednerf_torch.ops import encode_kernels as ek

SPEC3 = dict(n_levels=5, n_features=4, base_res=8, max_res=256,
             log2_hashmap_size=12, max_table_rows=512)
SPEC4 = dict(n_levels=4, n_features=4, base_res=8, max_res=128,
             log2_hashmap_size=12, max_table_rows=512, time_keyframes=4)


def _case(spec_kw, seed, n=256):
    js = jbg.BrickGridSpec(**spec_kw)
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 0.1, s).astype(np.float32)
              for k, s in js.param_shapes()}
    x = rng.uniform(0.02, 0.98, (n, 3)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (n, 1)).astype(np.float32)
    cot = rng.normal(0, 1, (n, js.output_dim)).astype(np.float32)
    return params, x, t, cot


def _jax(spec_kw, params, x, t, cot, dtype, jit=True):
    js = jbg.BrickGridSpec(**spec_kw)
    kf = js.time_keyframes > 0

    def loss(p, xx, tt):
        out = jbg.brick_encode(xx, p, js, t=tt if kf else None,
                               compute_dtype=dtype)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    fn = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)
    if jit:
        fn = jax.jit(fn)
    (_, out), (gp, gx, gt) = fn({k: jnp.asarray(v) for k, v in params.items()},
                                jnp.asarray(x), jnp.asarray(t))
    return (np.asarray(out, np.float32), {k: np.asarray(v)
                                          for k, v in gp.items()},
            np.asarray(gx), np.asarray(gt))


def _port(spec_kw, params, x, t, cot, dtype):
    ts = tbg.BrickGridSpec(**spec_kw)
    kf = ts.time_keyframes > 0
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    out = tbg.brick_encode(xt, tp, ts, t=tt if kf else None,
                           compute_dtype=dtype)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return (out.detach().float().numpy(),
            {k: v.grad.numpy() for k, v in tp.items()}, xt.grad.numpy(),
            tt.grad.numpy() if kf else None)


def _jax_cell_levels(spec_kw):
    """The levels JAX's brick_encode sends to a cell route (its dispatch
    conditions, cednerf_tpu/ops/brick_grid.py)."""
    js = jbg.BrickGridSpec(**spec_kw)
    out = []
    for lay in js.level_layout():
        if js.time_keyframes:
            out.append(js.row_layout in ("cell", "cellz", "cellfused")
                       and lay["rows"] * js.keyframes * jbg.CELLS_PER_BRICK
                       <= js.cell_rows_cap)
        else:
            zp = (jbg.ZROWS_PER_BRICK if js.row_layout == "cellz"
                  else jbg.CELLS_PER_BRICK)
            out.append(js.row_layout in ("cell", "cellz", "cellfused")
                       and lay["hashed"] and lay["rows"] * zp
                       <= js.cell_rows_cap)
    return out


@pytest.mark.parametrize("layout", ["brick", "cell", "cellz", "cellfused"])
def test_cell_levels_follow_jax(layout):
    bench = dict(n_levels=8, n_features=4, base_res=16, max_res=1024,
                 log2_hashmap_size=21, max_table_rows=16384,
                 fine_table_rows=65536, row_layout=layout)
    for kw in (bench, dict(SPEC3, row_layout=layout),
               dict(SPEC4, row_layout=layout),
               dict(SPEC3, row_layout=layout, cell_rows_cap=512 * 9),
               dict(bench, time_keyframes=4)):
        assert tbg.BrickGridSpec(**kw).cell_levels() == _jax_cell_levels(kw)
    if layout != "brick":
        # the bench default: hashed levels 3-4 (16,384 rows) cell, levels
        # 5-7 (65,536 rows, 1.77M cell rows) brick
        assert tbg.BrickGridSpec(**bench).cell_levels() == [
            False, False, False, True, True, False, False, False]


@pytest.mark.parametrize("layout,spec_kw", [
    ("cell", SPEC3), ("cellz", SPEC3), ("cellfused", SPEC3),
    ("cell", SPEC4), ("cellz", SPEC4), ("cellfused", SPEC4),
    ("cell", dict(SPEC3, cell_rows_cap=512 * 9)),
    ("cellz", dict(SPEC3, cell_rows_cap=512 * 9)),
    ("cell", dict(SPEC3, n_features=2))])
def test_cell_layout_f32_matches_jax(layout, spec_kw):
    kw = dict(spec_kw, row_layout=layout)
    cells = tbg.BrickGridSpec(**kw).cell_levels()
    if "cell_rows_cap" in spec_kw:       # some levels fall back to brick
        assert layout != "cell" or not any(cells)
        assert layout != "cellz" or any(cells)
    else:
        assert any(cells)
    case = _case(kw, seed=3)
    want = _jax(kw, *case, jnp.float32)
    got = _port(kw, *case, torch.float32)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-5)
    if kw.get("time_keyframes"):
        np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-5)
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def _bf16_ulps(a, b):
    """Distance in bf16 steps between two arrays of bf16 values."""
    def ordered(v):
        i = torch.from_numpy(np.ascontiguousarray(v)).to(
            torch.bfloat16).view(torch.int16).numpy().astype(np.int64) & 0xFFFF
        return np.where(i & 0x8000, 0x8000 - (i & 0x7FFF), 0x8000 + i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("spec_kw", [SPEC3, SPEC4],
                         ids=["3d", "4d"])
def test_cell_bf16_grads_keep_jax_rounding(spec_kw):
    kw = dict(spec_kw, row_layout="cell")
    case = _case(kw, seed=0)
    _, want, _, _ = _jax(kw, *case, jnp.bfloat16, jit=False)
    _, got, _, _ = _port(kw, *case, torch.bfloat16)
    _, brick, _, _ = _port(dict(spec_kw), *case, torch.bfloat16)
    layout = tbg.BrickGridSpec(**kw)
    names = [n for n, _ in layout.param_shapes()]
    for lvl, cell in enumerate(layout.cell_levels()):
        if not cell:
            continue
        name = names[lvl]
        w, g, b = want[name], got[name], brick[name]
        nz = w != 0
        assert nz.mean() > 0.01, name
        if name.startswith("bricks_"):
            # JAX's hashed cell gradient is bf16-valued: the rounding point
            # exists (a dense level's sums the overlapping bricks in f32)
            np.testing.assert_array_equal(
                torch.tensor(w).to(torch.bfloat16).float().numpy(), w)
        # within one bf16 ulp of JAX (in fact equal)
        assert _bf16_ulps(g, w).max() <= 1, name
        np.testing.assert_array_equal(g, w, err_msg=name)
        # the brick route's f32 gradient is further from JAX's cell one
        far = _bf16_ulps(b[nz], w[nz]) > 1
        assert far.mean() > 0.1, (name, far.mean())


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [1, 2, 4])
def test_fold_matches_jax_expansion_transpose(f, accum):
    """fold_cells (its plain version, which the wrapper runs on CPU tensors)
    against the vjp of JAX's _expand_cell_table, given the same per-cell
    gradient in the accumulator's dtype (JAX's _scatter_rows result): at a
    bf16 compute dtype equal; at f32 f32 sums of <= 8 terms of size ~1 in
    another order (rtol 1e-6). The fold writes the cell level's rows of
    the table gradient alone and zeroes the cell rows it read."""
    rng = np.random.default_rng(5)
    rows = 7
    d_cell = rng.normal(0, 1, (rows * 27, 8 * f)).astype(np.float32)
    d_cell[rng.uniform(size=d_cell.shape) < 0.3] = 0
    accum_bf16 = accum == "bfloat16"
    sums = jnp.asarray(d_cell).astype(jnp.dtype(accum))
    level_rows = [3, rows, 2]            # the cell level between two others
    ek.reset_counts()
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        _, vjp = jax.vjp(lambda tb: jbg._expand_cell_table(tb, f),
                         jnp.zeros((rows, 64 * f), jdt))
        want = np.asarray(vjp(sums.astype(jdt))[0], np.float32)
        cells = torch.from_numpy(d_cell.copy())
        d_table = torch.full((sum(level_rows), 64 * f), 7.0)
        got = ek.fold_cells(cells, d_table, level_rows, [-1, 0, -1], f,
                            dtype, accum_bf16)
        assert got is d_table and not cells.any()
        assert (d_table[:3] == 7).all() and (d_table[3 + rows:] == 7).all()
        if dtype == torch.bfloat16:
            np.testing.assert_array_equal(d_table[3:3 + rows].numpy(), want)
        else:
            np.testing.assert_allclose(d_table[3:3 + rows].numpy(), want,
                                       rtol=1e-6, atol=1e-6)
    assert ek.launches["fold_cells"] == 0
    assert ek.plain_cuda_calls["fold_cells"] == 0


def _old_fold_ops():
    """chip_smoke.py's old_fold_ops: the fold as the port ran it before its
    kernel (the slots gathered by the fold index, one .sum over them),
    kept there for the card's A/B and loaded from there."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.old_fold_ops


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cell_backward_wrappers_on_cpu(dtype, accum):
    """On CPU tensors the cell layouts' backward (fused_encode_bwd_cell:
    K6c, then the fold) returns its plain version's brick levels' rows and
    d_x, and the cell levels' rows folded as before the fold kernel (a
    .sum over the slots: equal at a bf16 compute dtype, f32 sums in
    another order at f32); no kernel launches."""
    spec = tbg.BrickGridSpec(**dict(SPEC3, row_layout="cell"))
    lay = spec.level_layout()
    scales, nbs = spec.level_scales(), [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    F, L = spec.n_features, spec.n_levels
    offs, off = [], 0
    for r, cell in zip(level_rows, spec.cell_levels()):
        offs.append(off if cell else -1)
        off += 27 * r if cell else 0
    assert off and min(offs) < 0
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(0, 1, (500, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (500, L * F)).astype(np.float32)
                         ).to(torch.bfloat16)
    table = torch.from_numpy(rng.normal(0, 1, (sum(level_rows), 64 * F))
                             .astype(np.float32)).to(torch.bfloat16)
    rows = torch.stack([tbg._level_geom(x, s, b, l["hashed"], l["rows"])[0]
                        for s, b, l in zip(scales, nbs, lay)])
    args = (x, g, rows, table, scales, nbs, level_rows, F, offs)
    bf16 = dtype == torch.bfloat16
    ek.reset_counts()
    want = ek.fused_encode_bwd_cell_plain(*args, bf16_terms=bf16)
    d_t, d_x = ek.fused_encode_bwd_cell(*args, dtype, accum == "bfloat16")
    assert torch.equal(d_x, want[2])
    old_fold, t0 = _old_fold_ops(), 0
    for r, c in zip(level_rows, offs):
        if c < 0:
            assert torch.equal(d_t[t0:t0 + r], want[0][t0:t0 + r])
        else:
            old = old_fold(want[1][c:c + 27 * r], F, dtype,
                           accum == "bfloat16")
            assert old.abs().max() > 0
            if bf16:
                assert torch.equal(d_t[t0:t0 + r], old)
            else:
                torch.testing.assert_close(d_t[t0:t0 + r], old, rtol=1e-6,
                                           atol=1e-6)
        t0 += r
    assert not any(ek.launches.values())


def test_k6c_plain_targets():
    """The plain K6c: with no cell level it is K6's plain version; with
    every level on the cell target, d_table is zero, d_x is unchanged and
    the folded f32 cell rows are K6's table gradient."""
    spec = tbg.BrickGridSpec(**dict(SPEC3, max_res=64))
    lay = spec.level_layout()
    scales, nbs = spec.level_scales(), [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    F, L = spec.n_features, spec.n_levels
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-0.05, 1.05, (300, 3)).astype(
        np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (300, L * F)).astype(np.float32)
                         ).to(torch.bfloat16)
    table = torch.from_numpy(rng.normal(0, 1, (sum(level_rows), 64 * F))
                             .astype(np.float32)).to(torch.bfloat16)
    rows = torch.stack([tbg._level_geom(x, s, b, l["hashed"], l["rows"])[0]
                        for s, b, l in zip(scales, nbs, lay)])
    want_t, want_x = ek.fused_encode_bwd_plain(x, g, rows, table, scales,
                                               nbs, level_rows, F)
    d_t, d_c, d_x = ek.fused_encode_bwd_cell_plain(
        x, g, rows, table, scales, nbs, level_rows, F, [-1] * L)
    assert d_c.shape == (0, 8 * F)
    assert torch.equal(d_t, want_t) and torch.equal(d_x, want_x)
    offs = np.cumsum([0] + [27 * r for r in level_rows])[:-1].tolist()
    d_t, d_c, d_x = ek.fused_encode_bwd_cell_plain(
        x, g, rows, table, scales, nbs, level_rows, F, offs,
        bf16_terms=False)
    assert not d_t.any() and torch.equal(d_x, want_x)
    folded = ek.fold_cells(d_c, torch.zeros_like(want_t), level_rows, offs,
                           F, torch.float32, False)
    torch.testing.assert_close(folded, want_t, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("route", [
    dict(), dict(interp_impl="interp"), dict(row_layout="cell"),
    dict(time_keyframes=4), dict(time_keyframes=4, row_layout="cell")],
    ids=["k5k6", "k1k2", "cell", "4d", "4d_cell"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_remat_feats_bit_identical(route, dtype):
    """remat_feats gathers again what the forward gathered: outputs and
    every gradient equal the run without it bit for bit (JAX's
    test_remat_feats_grads_identical), and on the K1/K2 route the forward
    saves no [L, N, 64F] rows."""
    kw = dict(SPEC4 if route.get("time_keyframes") else SPEC3, **route)
    case = _case(kw, seed=7)
    a = _port(kw, *case, dtype)
    b = _port(dict(kw, remat_feats=True), *case, dtype)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[2], b[2])
    if a[3] is not None:
        np.testing.assert_array_equal(a[3], b[3])
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k], err_msg=k)
    if route == dict(interp_impl="interp"):
        spec = tbg.BrickGridSpec(**kw, remat_feats=True)
        params, x = case[0], case[1]
        tp = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
        out = tbg.brick_encode(torch.tensor(x), tp, spec, compute_dtype=dtype)
        saved = out.grad_fn.saved_tensors
        assert max(s.numel() for s in saved) == max(
            v.size for v in params.values())
