"""The CUDA kernels K1, K5, K6, K6c, fold_cells, K2, K4, K3, K7 and K8
against their plain versions, the key-width sort against torch.sort (and
the reduces' bits with either sort) (K5 and K6 also at the proposal density
fields' layout), K4's cached scratch across calls, the cell layouts'
backward and its resident buffer, and the 4D keyframe encoder (whose
backward runs K3) against the CPU, on the card.

Marked `gpu`: without a CUDA card every test here skips. This file imports
neither jax nor the JAX package, so it runs on a machine that has only the
port's dependencies; there, skip the suite's JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: f32 output rtol 1e-5, atol 1e-9 (summation order only, at the
+-1e-4 table scale); bf16 output one bf16 rounding, rtol 2^-7. Backward
kernels (K6, K2: one kernel body, on the table or on the gathered rows):
their table-gradient reduce sums each row in two levels (tiles of 256
sorted terms, then the tiles in order) where the plain version's
index_add adds in one, so each gradient is held to 1e-5 of its largest
entry (plus rtol 1e-5); with one tile (strict sorted order) the reduce
equals the plain version on the CPU bit for bit. K6, K6c, K2 and K3 give
the same bits in three launches; K2's d_x, summed in level order, too.
fold_cells against its plain version: bit for bit (the same roundings and
f32 sums in the same order); K6c + fold against the plain pair: each
folded entry within one bf16 step plus 1e-4 of the largest (the fold
rounds to bf16 sums that atomics added in another order). K4
(compaction) is integer work: bit-exact. K3 (row scatter-add) sums in the
reduce's two levels against index_add's order: 1e-5 of the largest entry,
as K6.
The 4D encoder on the card against the CPU: the
forward is the same PyTorch code on both (bf16 out, rtol 2^-7: one bf16
rounding of f32 sums taken in another order); its gradients 1e-5 of each
array's largest entry (K3's two-level sums, and the reductions' order). K7
(update rows): the rows are the same f32 products in the same order as the
plain version's, d_x sums them in another order: 1e-5 of each array's
largest entry. K8 (row gather) copies bytes: bit-exact.
"""

import numpy as np
import pytest
import torch

from cednerf_torch.ops import brick_grid as tbg
from cednerf_torch.ops import compact_kernels as ck
from cednerf_torch.ops import encode_kernels as ek
from cednerf_torch.ops import gather_kernels as gk
from cednerf_torch.ops import scatter_kernels as sk
from cednerf_torch.utils.bench import cell_points, ray_major_samples

pytestmark = pytest.mark.gpu


def _cuda_inputs(seed, n_feat, n, levels, points=None):
    """Tables of +-1e-4 and positions for a spec of `levels` levels: n
    uniform points in and just around the unit cube, or with
    points="cells" bench.cell_points (every intra cell and cell and brick
    boundaries of each level) and n uniform ones after them, or with
    points="one brick" n points inside one level-0 brick, or with
    points="ray major" the first n of bench.ray_major_samples (64 samples
    a ray in ray order: long runs of a warp's lanes in one cell)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = tbg.BrickGridSpec(n_levels=levels, n_features=n_feat, base_res=16,
                             max_res=512, log2_hashmap_size=16,
                             max_table_rows=2048)
    rng = np.random.default_rng(seed)
    lay = spec.level_layout()
    tables = [rng.uniform(-1e-4, 1e-4, (l["rows"], 64 * n_feat))
              .astype(np.float32) for l in lay]
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    x = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    if points == "cells":
        x = np.concatenate([cell_points(scales, nbs, seed), x])
    elif points == "one brick":
        # pos = x * scale + 0.5 in [3.01, 5.99): brick 1 of level 0 per axis
        x = ((rng.uniform(3.01, 5.99, (n, 3)) - 0.5)
             / np.float32(scales[0])).astype(np.float32)
    elif points == "ray major":
        x = ray_major_samples(-(-n // 64), 64, seed)[0][:n]
    x = torch.from_numpy(x).cuda()
    level_rows = [l["rows"] for l in lay]
    rows = torch.stack([tbg._level_geom(x, scales[i], nbs[i], l["hashed"],
                                        l["rows"])[0]
                        for i, l in enumerate(lay)]).contiguous()
    table = torch.from_numpy(np.concatenate(tables)).to(torch.bfloat16).cuda()
    offs = np.cumsum([0] + level_rows)
    feats = torch.stack([table[offs[i]:offs[i + 1]][rows[i].long()]
                         for i in range(levels)]).contiguous()
    return x, table, rows, feats, scales, nbs, level_rows


@pytest.mark.parametrize("n_feat,n,levels,points", [
    (4, 1001, 8, None), (2, 4099, 16, None), (1, 33, 3, None),
    (4, 101, 8, "cells"), (2, 77, 5, "cells"), (1, 5, 3, "cells")])
def test_kernels_match_plain(n_feat, n, levels, points):
    """K5 and K1 against K5's plain version; with points="cells" on every
    intra cell and on cell and brick boundaries of each level."""
    x, table, rows, feats, scales, nbs, level_rows = _cuda_inputs(
        0, n_feat, n, levels, points)
    want = ek.fused_encode_fwd_plain(x, table, rows, scales, nbs, level_rows,
                                     n_feat, torch.float32)
    for out_dtype, rtol, atol in ((torch.float32, 1e-5, 1e-9),
                                  (torch.bfloat16, 2.0 ** -7, 1e-9)):
        k5 = ek.fused_encode_fwd(x, table, rows, scales, nbs, level_rows,
                                 n_feat, out_dtype)
        k1 = ek.interp_fwd(x, feats, scales, nbs, n_feat, out_dtype)
        torch.cuda.synchronize()
        for got in (k5, k1):
            assert got.dtype == out_dtype
            torch.testing.assert_close(got.float(), want, rtol=rtol,
                                       atol=atol)


@pytest.mark.parametrize("points", [None, "cells", "one brick"])
@pytest.mark.parametrize("n_feat", [1, 2, 4])
def test_k1_matches_its_plain_version(n_feat, points):
    """K1 against interp_fwd_plain on the same gathered rows, both output
    dtypes: uniform points (a ragged N), every intra cell and cell and
    brick boundary of each level, and a batch in one level-0 brick."""
    n = {None: 4099, "cells": 101, "one brick": 20000}[points]
    x, _, _, feats, scales, nbs, _ = _cuda_inputs(5, n_feat, n, 8, points)
    want = ek.interp_fwd_plain(x, feats, scales, nbs, n_feat, torch.float32)
    for out_dtype, rtol, atol in ((torch.float32, 1e-5, 1e-9),
                                  (torch.bfloat16, 2.0 ** -7, 1e-9)):
        ek.reset_counts()
        got = ek.interp_fwd(x, feats, scales, nbs, n_feat, out_dtype)
        torch.cuda.synchronize()
        assert ek.launches["interp_fwd"] == 1
        assert ek.plain_cuda_calls["interp_fwd"] == 0
        assert got.dtype == out_dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


def test_k5_clamps_rows_like_its_plain_version():
    x, table, rows, _, scales, nbs, level_rows = _cuda_inputs(2, 4, 777, 8)
    lim = torch.tensor(level_rows, dtype=torch.int32, device="cuda")[:, None]
    gen = torch.Generator(device="cuda").manual_seed(2)
    pick = torch.rand(rows.shape, device="cuda", generator=gen)
    bad = torch.where(pick < 0.15, -3, torch.where(pick < 0.3, lim + 5, rows))
    bad = bad.to(torch.int32).contiguous()
    want = ek.fused_encode_fwd_plain(x, table, bad, scales, nbs, level_rows,
                                     4, torch.float32)
    got = ek.fused_encode_fwd(x, table, bad, scales, nbs, level_rows, 4,
                              torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-9)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, table, rows, feats, scales, nbs, level_rows = _cuda_inputs(1, 4, 64, 4)
    with pytest.raises(ValueError):
        ek.fused_encode_fwd(x, table.float(), rows, scales, nbs, level_rows, 4)
    with pytest.raises(ValueError):
        ek.fused_encode_fwd(x, table, rows.long(), scales, nbs, level_rows, 4)
    with pytest.raises(ValueError):
        ek.interp_fwd(x, feats[:, :10], scales, nbs, 4)
    spec = tbg.BrickGridSpec(n_levels=2, n_features=4, interp_impl="plain")
    params = {k: v.cuda() for k, v in
              spec.init_params(torch.Generator().manual_seed(0)).items()}
    with torch.no_grad(), pytest.raises(ValueError, match="plain"):
        tbg.brick_encode(x, params, spec)


def _close_to_scale(got, want):
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale + 1e-30)


@pytest.mark.parametrize("res,unbounded", [(128, False), (256, True)])
def test_prop_layout_kernels_match_plain(res, unbounded):
    """K5 and K6 at the proposal density fields' layout (NGPDensityField:
    L5 F2, 2^17, 16 -> res): the field's own tables for K5 (both output
    dtypes, test_kernels_match_plain's limits), tables of +-1 for K6
    (test_backward_kernels_match_plain's), on 262,144 positions uniform
    over the unit cube and as many contracted ones (random directions at
    distances uniform in disparity, contract_to_unisphere), where the far
    samples pile up in the outer shell."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cednerf_torch.models.field import (NGPDensityField,
                                            contract_to_unisphere)

    aabb = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    net = NGPDensityField(aabb=aabb, unbounded=unbounded,
                          max_resolution=res).reset_parameters(
        torch.Generator().manual_seed(0)).cuda()
    spec = net.grid.bspec
    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    gen = torch.Generator(device="cuda").manual_seed(res)
    n = 262_144
    d = torch.randn((n, 3), device="cuda", generator=gen)
    r = 1.0 / (1e-4 + (1 - 1e-4) * torch.rand((n, 1), device="cuda",
                                             generator=gen))
    a = net._aabb_t
    inputs = {"uniform": torch.rand((n, 3), device="cuda", generator=gen),
              "contracted": contract_to_unisphere(
                  d / torch.linalg.norm(d, dim=-1, keepdim=True) * r,
                  a[:3], a[3:]).contiguous()}
    with torch.no_grad():
        table = torch.cat(tbg.level_tables(net.grid.tables(), spec)).to(
            torch.bfloat16).contiguous()
    big = ((torch.rand(table.shape, device="cuda", generator=gen) * 2 - 1)
           .to(torch.bfloat16))
    for x in inputs.values():
        rows = torch.stack([tbg._level_geom(x, scales[i], nbs[i],
                                            l["hashed"], l["rows"])[0]
                            for i, l in enumerate(lay)]).contiguous()
        want = ek.fused_encode_fwd_plain(x, table, rows, scales, nbs,
                                         level_rows, 2, torch.float32)
        for out_dtype, rtol, atol in ((torch.float32, 1e-5, 1e-9),
                                      (torch.bfloat16, 2.0 ** -7, 1e-9)):
            got = ek.fused_encode_fwd(x, table, rows, scales, nbs,
                                      level_rows, 2, out_dtype)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want, rtol=rtol,
                                       atol=atol)
        g = torch.randn((n, 10), device="cuda", generator=gen).to(
            torch.bfloat16)
        g[::7] = 0
        want_t, want_x = ek.fused_encode_bwd_plain(x, g, rows, big, scales,
                                                   nbs, level_rows, 2)
        got_t, got_x = ek.fused_encode_bwd(x, g, rows, big, scales, nbs,
                                           level_rows, 2)
        torch.cuda.synchronize()
        _close_to_scale(got_t, want_t)
        _close_to_scale(got_x, want_x)


@pytest.mark.parametrize("n_feat,n,levels,points", [
    (4, 1001, 8, None), (2, 4099, 16, None), (1, 33, 3, None),
    (4, 20000, 4, None), (4, 101, 8, "cells"), (2, 77, 5, "cells"),
    (1, 5, 3, "cells"), (4, 20000, 8, "one brick"),
    (2, 4097, 3, "one brick"), (4, 20000, 8, "ray major"),
    (1, 4099, 5, "ray major")])
def test_backward_kernels_match_plain(n_feat, n, levels, points):
    """K6 and K2 (one kernel body) against K6's plain version; "cells" as
    in test_kernels_match_plain, "one brick" puts every sample into one
    level-0 brick (one key across many reduce tiles), "ray major" gives
    long runs of one key inside a tile."""
    x, table, rows, feats, scales, nbs, level_rows = _cuda_inputs(
        3, n_feat, n, levels, points)
    gen = torch.Generator(device="cuda").manual_seed(3)
    g = (torch.randn((x.shape[0], levels * n_feat), device="cuda",
                     generator=gen)).to(torch.bfloat16)
    g[::7] = 0          # unused budget slots carry a zero cotangent
    want_t, want_x = ek.fused_encode_bwd_plain(x, g, rows, table, scales, nbs,
                                               level_rows, n_feat)
    k6 = ek.fused_encode_bwd(x, g, rows, table, scales, nbs, level_rows,
                             n_feat)
    k2 = ek.interp_bwd_fused(x, g, feats, rows, scales, nbs, level_rows,
                             n_feat)
    torch.cuda.synchronize()
    for d_table, d_x in (k6, k2):
        assert d_table.dtype == torch.float32 and d_x.dtype == torch.float32
        _close_to_scale(d_table, want_t)
        _close_to_scale(d_x, want_x)
    k2_plain = ek.interp_bwd_fused_plain(x, g, feats, rows, scales, nbs,
                                         level_rows, n_feat)
    _close_to_scale(k2_plain[0], want_t)
    _close_to_scale(k2_plain[1], want_x)


def _cell_offsets(spec):
    """K6c's and fold_cells' cell_rows: the hashed levels' cell rows back
    to back, -1 for the dense levels (which keep K6's brick target)."""
    offs, off = [], 0
    for lay in spec.level_layout():
        offs.append(off if lay["hashed"] else -1)
        off += 27 * lay["rows"] if lay["hashed"] else 0
    assert off > 0
    return offs


def _bf16_close(got, want):
    """Each entry within one bf16 step of want's plus 1e-4 of its largest
    entry: a fold's bf16 rounding of f32 sums that atomics added in
    another order."""
    step = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    bad = (got - want).abs() > step + 1e-4 * want.abs().max()
    assert not bool(bad.any()), (got[bad][:8], want[bad][:8])


@pytest.mark.parametrize("n_feat,n,levels,points", [
    (4, 1001, 8, None), (2, 4099, 8, None), (1, 33, 3, None),
    (4, 3001, 16, None), (4, 101, 8, "cells"), (4, 20000, 8, "one brick"),
    (4, 20000, 8, "ray major")])
def test_k6c_matches_plain(n_feat, n, levels, points):
    """K6c (the cell layouts' backward) against its plain version, the
    hashed levels on the per-cell target and the dense ones on K6's: K6c
    launched into zeroed buffers, its brick levels' table gradient, its
    cell rows and d_x each within 1e-5 of its largest entry, as K6 (the
    same bf16 terms, summed in another order); then the wrapper (K6c
    into the resident buffer, then fold_cells): the brick levels' rows and
    d_x as K6c's, the cell levels' rows against the plain fold of the plain
    cell rows (_bf16_close), and the resident buffer zero again."""
    x, table, rows, feats, scales, nbs, level_rows = _cuda_inputs(
        3, n_feat, n, levels, points)
    spec = tbg.BrickGridSpec(n_levels=levels, n_features=n_feat,
                             base_res=16, max_res=512, log2_hashmap_size=16,
                             max_table_rows=2048)
    offs = _cell_offsets(spec)
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = torch.randn((x.shape[0], levels * n_feat), device="cuda",
                    generator=gen).to(torch.bfloat16)
    g[::7] = 0
    args = (x, g, rows, table, scales, nbs, level_rows, n_feat, offs)
    want = ek.fused_encode_bwd_cell_plain(*args)
    ek.reset_counts()
    d_t, d_c = torch.zeros_like(want[0]), torch.zeros_like(want[1])
    d_x = torch.empty_like(want[2])
    ek._launch_k6c(*args, d_t, d_c, d_x)
    torch.cuda.synchronize()
    brick = torch.repeat_interleave(torch.tensor([o < 0 for o in offs]),
                                    torch.tensor(level_rows)).cuda()
    _close_to_scale(d_t[brick], want[0][brick])
    _close_to_scale(d_c, want[1])
    _close_to_scale(d_x, want[2])
    got_t, got_x = ek.fused_encode_bwd_cell(*args, torch.bfloat16, False)
    ek.fold_cells_plain(want[1], want[0], level_rows, offs, n_feat,
                        torch.bfloat16, False)
    torch.cuda.synchronize()
    assert all(not b.any() for b in ek.cell_buffers())
    _close_to_scale(got_t[brick], want[0][brick])
    _close_to_scale(got_x, want[2])
    _bf16_close(got_t[~brick], want[0][~brick])
    assert ek.launches["fused_encode_bwd_cell"] == 2
    assert ek.launches["fold_cells"] == 1


@pytest.mark.parametrize("n_feat", [4, 2, 1])
@pytest.mark.parametrize("accum_bf16", [False, True])
@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32])
def test_fold_cells_matches_plain(n_feat, accum_bf16, compute):
    """fold_cells against its plain version on the same card tensors: the
    folded rows bit for bit, every other row of the table gradient left as
    it was, the cell rows it read zero. Two cell levels with a brick level
    between them, of row counts that split the kernel's blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    level_rows, offs = [13, 5, 2051], [0, -1, 27 * 13]
    gen = torch.Generator(device="cuda").manual_seed(n_feat)
    d_cell = torch.randn((27 * (13 + 2051), 8 * n_feat), device="cuda",
                         generator=gen) * 100
    d_cell[torch.rand(d_cell.shape, device="cuda", generator=gen) < 0.3] = 0
    fill = torch.randn((sum(level_rows), 64 * n_feat), device="cuda",
                       generator=gen)
    want_c, want_t = d_cell.clone(), fill.clone()
    ek.fold_cells_plain(want_c, want_t, level_rows, offs, n_feat, compute,
                        accum_bf16)
    got_t = fill.clone()
    ek.reset_counts()
    assert ek.fold_cells(d_cell, got_t, level_rows, offs, n_feat, compute,
                         accum_bf16) is got_t
    torch.cuda.synchronize()
    assert ek.launches["fold_cells"] == 1
    assert not d_cell.any() and not want_c.any()
    assert torch.equal(got_t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(got_t[13:18], fill[13:18])


def _unique_row_x(spec, n, seed):
    """Up to n points of the unit cube no two of which share a brick row
    on any level of spec: each address of the backward then takes at most
    one atomic add, so its gradients do not depend on the adds' order."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((1 << 16, 3), device="cuda", generator=gen)
    rows = torch.stack([tbg._level_geom(x, s, l["n_bricks_axis"],
                                        l["hashed"], l["rows"])[0]
                        for s, l in zip(spec.level_scales(),
                                        spec.level_layout())]).cpu().numpy()
    used = [set() for _ in range(rows.shape[0])]
    keep = []
    for i in range(rows.shape[1]):
        if all(rows[l, i] not in used[l] for l in range(len(used))):
            keep.append(i)
            for l in range(len(used)):
                used[l].add(rows[l, i])
            if len(keep) == n:
                break
    return x[torch.tensor(keep, device="cuda")]


@pytest.mark.parametrize("keyframes", [0, 4], ids=["3d", "4d"])
def test_cell_backward_leaves_its_buffer_zero(keyframes):
    """brick_encode's backward on the cell layout: K6c once and fold_cells
    once (3D, every cell level in one launch) or K3 and fold_cells once a
    cell level (4D), and the resident cell buffers all zero after each
    backward; two backwards in a row on a batch of one sample a brick row
    give the same gradients bit for bit (a buffer left unzeroed would add
    the first into the second)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = tbg.BrickGridSpec(n_levels=8, n_features=4, base_res=16,
                             max_res=512, log2_hashmap_size=16,
                             max_table_rows=2048, row_layout="cell",
                             grad_accum_dtype="bfloat16",
                             time_keyframes=keyframes)
    cells = spec.cell_levels()
    assert any(cells) and not all(cells) or keyframes
    x = _unique_row_x(spec, 200, 11)
    gen = torch.Generator(device="cuda").manual_seed(11)
    t = torch.rand((x.shape[0], 1), device="cuda", generator=gen)
    cot = torch.randn((x.shape[0], spec.output_dim), device="cuda",
                      generator=gen)
    params = {k: torch.rand(s, device="cuda", generator=gen) * 2 - 1
              for k, s in spec.param_shapes()}
    runs = []
    for _ in range(2):
        ek.reset_counts()
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xr = x.clone().requires_grad_()
        out = tbg.brick_encode(xr, p, spec, t=t if keyframes else None)
        (out.float() * cot).sum().backward()
        torch.cuda.synchronize()
        assert all(not b.any() for b in ek.cell_buffers())
        assert ek.launches["fold_cells"] == (sum(cells) if keyframes else 1)
        assert ek.launches["fused_encode_bwd_cell"] == (0 if keyframes
                                                        else 1)
        runs.append([xr.grad] + [p[k].grad for k in sorted(p)])
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n_feat,points", [(4, "ray major"), (2, None)])
def test_k2_d_x_is_deterministic(n_feat, points):
    """d_x is summed over the levels in level order, so two launches of K2
    give the same bits (the table gradient too: test_backward_bits_repeat
    holds that)."""
    x, _, rows, feats, scales, nbs, level_rows = _cuda_inputs(
        6, n_feat, 30011, 8, points)
    gen = torch.Generator(device="cuda").manual_seed(6)
    g = torch.randn((x.shape[0], 8 * n_feat), device="cuda",
                    generator=gen).to(torch.bfloat16)
    g[::5] = 0
    ek.reset_counts()
    runs = [ek.interp_bwd_fused(x, g, feats, rows, scales, nbs, level_rows,
                                n_feat) for _ in range(2)]
    torch.cuda.synchronize()
    assert ek.launches["interp_bwd_fused"] == 2
    assert ek.plain_cuda_calls["interp_bwd_fused"] == 0
    assert torch.equal(runs[0][1].view(torch.int32),
                       runs[1][1].view(torch.int32))
    _close_to_scale(runs[1][0], runs[0][0])


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("points", [None, "ray major", "one brick"])
@pytest.mark.parametrize("kernel", ["k6", "k6c", "k2", "k3"])
def test_backward_bits_repeat(kernel, points):
    """K6, K6c (with its fold), K2 and K3 launched three times on the same
    inputs give the same bits: uniform samples, ray-major ones (runs of one
    key inside a tile) and all samples in one level-0 brick (one key
    across hundreds of tiles, through the folded carry)."""
    x, table, rows, feats, scales, nbs, level_rows = _cuda_inputs(
        7, 4, 20000, 8, points)
    gen = torch.Generator(device="cuda").manual_seed(7)
    g = torch.randn((x.shape[0], 8 * 4), device="cuda",
                    generator=gen).to(torch.bfloat16)
    g[::9] = 0
    spec = tbg.BrickGridSpec(n_levels=8, n_features=4, base_res=16,
                             max_res=512, log2_hashmap_size=16,
                             max_table_rows=2048)
    if kernel == "k6":
        def run():
            return ek.fused_encode_bwd(x, g, rows, table, scales, nbs,
                                       level_rows, 4)
    elif kernel == "k6c":
        def run():
            return ek.fused_encode_bwd_cell(
                x, g, rows, table, scales, nbs, level_rows, 4,
                _cell_offsets(spec), torch.bfloat16, False)
    elif kernel == "k2":
        def run():
            return ek.interp_bwd_fused(x, g, feats, rows, scales, nbs,
                                       level_rows, 4)
    else:
        upd = torch.randn((2 * x.shape[0], 256), device="cuda",
                          generator=gen)
        k3_rows = torch.cat([rows[0], rows[0] + 1]).contiguous()

        def run():
            return (sk.scatter_add_rows(k3_rows, upd, level_rows[0] + 1),)
    runs = [run() for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(_bits(a), _bits(b))


def _torch_sort(keys, n_keys, lib=None):
    """key_sort's function by torch.sort(stable=True): the keys outside
    [0, n_keys) as n_keys, an int32 index."""
    k = torch.where((keys >= 0) & (keys < n_keys), keys, n_keys)
    s, p = torch.sort(k, stable=True)
    return s, p.to(torch.int32)


@pytest.mark.parametrize("m,n_keys,case", [
    (0, 5, "random"), (1, 1, "random"), (100003, 82976, "random"),
    (4097, 300, "equal"), (70001, 3145728, "sorted"),
    (262145, 2 ** 24, "random"), (5000, 2 ** 31 - 1, "random"),
    (300000, 1000, "dropped"), (16385, 82976, "random"),
    (1000, 82976, "random"), (20000, 1, "random"),
    (40000, 2 ** 31 - 1, "random"), (49157, 1000, "all dropped"),
    (600001, 4194304, "random")])
@pytest.mark.parametrize("lib", ["scatter_add_rows", "brick_encode_bwd"])
def test_key_sort_matches_torch_sort(m, n_keys, case, lib):
    """The key-width sort from either library that exports it: the sorted
    keys and the permutation equal torch.sort(stable=True)'s bit for bit
    (out-of-range keys mapped to n_keys first): random keys with negative
    ones, keys >= n_keys and INT_MAX among them, all-equal, sorted keys,
    1 to 31 key bits, M 0, 1, below one block, one past a tile (a
    cluster's keys) and not a multiple of a sort block, every key dropped
    over several tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(m)
    hi = min(n_keys + 3, 2 ** 31 - 1)
    keys = torch.randint(-2, hi, (m,), device="cuda", generator=gen,
                         dtype=torch.int32)
    if case == "equal":
        keys.fill_(n_keys // 2)
    elif case == "sorted":
        keys = torch.sort(keys)[0]
    elif case == "dropped":
        keys[::3] = 2 ** 31 - 1
    elif case == "all dropped":
        keys = torch.where(keys % 2 == 0, 2 ** 31 - 1, -1 - keys.abs())
    library = {"scatter_add_rows": sk._LIB, "brick_encode_bwd": ek._BWD}[lib]
    sk.reset_counts()
    got = sk.key_sort(keys, n_keys, library)
    want = _torch_sort(keys, n_keys)
    torch.cuda.synchronize()
    assert sk.launches["key_sort"] == (1 if m else 0)
    assert got[0].dtype == got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("points", [None, "one brick"])
@pytest.mark.parametrize("kernel", ["k6", "k6c", "k2", "k3"])
def test_reduce_bits_same_with_either_sort(kernel, points, monkeypatch):
    """K6, K6c, K2 and K3 give the same bits with the key-width sort as
    with torch.sort(stable=True) in its place: one stable permutation."""
    x, table, rows, feats, scales, nbs, level_rows = _cuda_inputs(
        12, 4, 20000, 8, points)
    gen = torch.Generator(device="cuda").manual_seed(12)
    g = torch.randn((x.shape[0], 8 * 4), device="cuda",
                    generator=gen).to(torch.bfloat16)
    g[::9] = 0
    spec = tbg.BrickGridSpec(n_levels=8, n_features=4, base_res=16,
                             max_res=512, log2_hashmap_size=16,
                             max_table_rows=2048)
    upd = torch.randn((16 * x.shape[0], 4), device="cuda", generator=gen)
    key = (rows[0].long() * 4)[:, None] * 64 + torch.randint(
        0, 64, (x.shape[0], 8), device="cuda", generator=gen)
    k3_rows = torch.cat([key, key + 64]).reshape(-1).to(
        torch.int32).contiguous()
    n3 = (level_rows[0] * 4 + 1) * 64
    run = {
        "k6": lambda: ek.fused_encode_bwd(x, g, rows, table, scales, nbs,
                                          level_rows, 4),
        "k6c": lambda: ek.fused_encode_bwd_cell(
            x, g, rows, table, scales, nbs, level_rows, 4,
            _cell_offsets(spec), torch.bfloat16, False),
        "k2": lambda: ek.interp_bwd_fused(x, g, feats, rows, scales, nbs,
                                          level_rows, 4),
        "k3": lambda: (sk.scatter_add_rows(k3_rows, upd, n3),)}[kernel]
    ours = run()
    monkeypatch.setattr(sk, "key_sort", _torch_sort)
    monkeypatch.setattr(ek, "key_sort", _torch_sort)
    theirs = run()
    torch.cuda.synchronize()
    for a, b in zip(ours, theirs):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("points", [None, "one brick"])
@pytest.mark.parametrize("cell", [False, True])
def test_table_reduce_in_one_tile_equals_plain_on_cpu(points, cell):
    """With one tile the reduce sums each key in strict sorted order, as
    the plain version does on the CPU (index_add_ in index order): the same
    bits, brick and cell targets, over a NaN-filled table gradient (every
    brick level's row written, zeros where no key lands; the cell level's
    rows left as they were); with the default tile it holds the folded
    carry's two levels to 1e-5 of the largest entry, and has the plain
    version's bits on every key whose entries lie in one tile."""
    x, table, rows, feats, scales, nbs, level_rows = _cuda_inputs(
        8, 4, 4099, 3, points)
    gen = torch.Generator(device="cuda").manual_seed(8)
    g = torch.randn((x.shape[0], 3 * 4), device="cuda",
                    generator=gen).to(torch.bfloat16)
    g[::5] = 0
    offs = np.cumsum([0] + level_rows)
    n_table = int(offs[-1])
    keys = (rows.long() + torch.tensor(offs[:-1], device="cuda")[:, None])
    n_cell, cell_rows = 0, None
    if cell:        # the last level on the cell target
        cidx = ek.cell_index(x, scales[-1], nbs[-1])
        keys[-1] = n_table + rows[-1].long() * 27 + cidx
        n_cell, cell_rows = 27 * level_rows[-1], [-1, -1, 0]
    zero = (g.float().view(-1, 3, 4) == 0).all(-1).t()
    keys = torch.where(zero, torch.iinfo(torch.int32).max,
                       keys).to(torch.int32).contiguous()
    brick = slice(0, int(offs[-2]) if cell else n_table)

    def buffers(device):
        return (torch.full((n_table, 256), float("nan"), device=device),
                torch.zeros((n_cell, 32), device=device) if cell else None)

    def reduce(device, tile=sk.REDUCE_TILE):
        return ek._table_reduce(keys.to(device), x.to(device), g.to(device),
                                scales, nbs, level_rows, 4,
                                *buffers(device), cell_rows, tile=tile)

    want = reduce("cpu")
    one = reduce("cuda", keys.numel())
    tiled = reduce("cuda")
    torch.cuda.synchronize()
    assert not want[0][brick].isnan().any()
    # the keys whose sorted entries lie in one tile of REDUCE_TILE
    k = sk.key_sort_plain(keys.cpu().reshape(-1), n_table + n_cell)[0].long()
    t = torch.arange(k.numel()) // sk.REDUCE_TILE
    span = [torch.zeros(n_table + n_cell + 1, dtype=torch.long)
            .scatter_reduce(0, k, t, op, include_self=False)
            for op in ("amin", "amax")]
    single = (span[0] == span[1])[:-1]
    assert not single.all()
    for a, b, c, s in zip(one, want, tiled,
                          (single[:n_table], single[n_table:])):
        if b is not None:
            assert torch.equal(_bits(a.cpu()), _bits(b))
            assert torch.equal(_bits(c.cpu()[s]), _bits(b[s]))
            _close_to_scale(c.cpu()[brick] if c.shape[1] == 256 else c.cpu(),
                            b[brick] if b.shape[1] == 256 else b)


@pytest.mark.parametrize("points", [None, "one brick"])
def test_carry_kernels_equal_plain_on_cpu(points):
    """The carry folded into the reduces (table_reduce's, K3's): every row
    whose run crosses a tile edge equal bit for bit to carry_plain's sum,
    on CPU copies, of the partial rows that the same launch left (both add
    the partials in tile order); the counters all zero again after it."""
    x, table, rows, feats, scales, nbs, level_rows = _cuda_inputs(
        9, 4, 20000, 8, points)
    gen = torch.Generator(device="cuda").manual_seed(9)
    g = torch.randn((x.shape[0], 8 * 4), device="cuda",
                    generator=gen).to(torch.bfloat16)
    offs = torch.tensor(np.cumsum([0] + level_rows)[:-1], device="cuda")
    keys = (rows.long() + offs[:, None]).to(torch.int32).contiguous()
    tile, n_table = sk.REDUCE_TILE, sum(level_rows)
    part = torch.empty((2, -(-keys.numel() // tile), 256), device="cuda")
    got = ek._table_reduce(keys, x, g, scales, nbs, level_rows, 4,
                           torch.empty((n_table, 256), device="cuda"),
                           part=part)[0]
    skeys = sk.key_sort(keys.reshape(-1), n_table, ek._BWD)[0]
    chained, want = sk.carry_plain(skeys.cpu(), part.cpu(), tile, n_table)
    torch.cuda.synchronize()
    assert len(chained) and bool(want.any())
    assert torch.equal(got.cpu()[chained], want)
    upd = torch.randn((2 * x.shape[0], 256), device="cuda", generator=gen)
    rows3 = torch.cat([rows[0], rows[0] + 1]).contiguous()
    n3 = level_rows[0] + 1
    part3 = torch.empty((2, -(-rows3.numel() // tile), 256), device="cuda")
    got3 = sk._scatter_add_rows(rows3, upd, n3, part=part3)
    k3 = sk.key_sort(rows3, n3)[0]
    chained3, want3 = sk.carry_plain(k3.cpu(), part3.cpu(), tile, n3)
    torch.cuda.synchronize()
    assert len(chained3) and bool(want3.any())
    assert torch.equal(got3.cpu()[chained3], want3)
    assert not any(bool(c.any()) for c in sk._CARRY_COUNTS.values())


@pytest.mark.parametrize("r,m,budget,p", [
    (64, 128, 2048, 0.3), (32, 256, 1024, 0.9), (24, 97, 512, 0.5),
    (7, 3, 100, 1.0), (256, 1024, 262144, 1.0), (300, 1024, 262144, 0.1),
    (16, 1024, 4096, 0.0), (1000, 1000, 1, 0.5),
    # several tiles (ck.TILE candidates): the budget inside one, on a tile
    # edge, an n that is not a multiple of 16, a budget above n (sentinel
    # fill over several fill blocks), the top ray bucket at ~10%
    (64, 512, 5000, 0.5), (64, 512, 2 * ck.TILE, 1.0),
    (37, 1000, 9000, 0.6), (20, 1000, 30000, 0.4),
    (16000, 1024, 262144, 0.1),
    # the scanned train path's lattices: march_seg's segments [R, 128] and
    # samples [49152, 8] (48 tiles), the skip lattice [R, 512]
    (16384, 128, 49152, 0.3), (49152, 8, 262144, 0.5),
    (16384, 512, 262144, 0.1)])
def test_compact_kernel_bit_exact(r, m, budget, p):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(r + m)
    valid = torch.rand((r, m), device="cuda", generator=gen) < p
    want = ck.compact_select_rayfold(valid, budget)
    got = ck.compact_select_kernel(valid, budget)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("r,m,budget,p,n_blocks", [
    (16000, 1024, 262144, 0.1, 2), (16000, 1024, 262144, 0.1, 4),
    (16000, 1024, 262144, 0.1, 8), (64, 128, 2048, 0.3, 2),
    # block sizes that are no multiple of 16 (scalar loads at the edges),
    # a budget share above a block's candidates, one candidate a ray
    (3000, 333, 32768, 0.1, 8), (24, 97, 512, 0.5, 4), (40, 7, 400, 0.9, 8),
    (8, 1, 8, 1.0, 8), (16384, 128, 49152, 0.3, 2)])
def test_compact_kernel_blocks_bit_exact(r, m, budget, p, n_blocks):
    """Blocked K4 (cfg.compact_blocks > 1) against its plain version
    (compact_select, the port of JAX's), with block 0 emptied and the last
    block filled (it overflows its share of the budget)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(r + m + n_blocks)
    valid = torch.rand((r, m), device="cuda", generator=gen) < p
    rb = r // n_blocks
    valid[:rb] = False
    valid[-rb:] = True
    want = ck.compact_select(valid, budget, n_blocks)
    got = ck.compact_select_kernel(valid, budget, n_blocks)
    again = ck.compact_select_kernel(valid, budget, 1)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    one = ck.compact_select_rayfold(valid, budget)
    assert torch.equal(again[0], one[0]) and torch.equal(again[1], one[1])


def test_compact_kernel_reuses_its_scratch():
    """Back-to-back K4 calls on different lattices, with no sync between
    them, through one cached scratch: each call advances the epoch in the
    tile counter word and leaves no claim behind, so no call reads the
    status words of the one before. Then a lattice of more tiles than the
    scratch holds (it grows once) and a small one after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = [((300, 1024), 0.3, 50000), ((120, 1000), 0.7, 70000),
             ((300, 1024), 0.05, 262144), ((7, 3), 1.0, 5),
             ((64, 512), 0.5, 5000)]
    lattices = [(torch.rand(shape, device="cuda", generator=gen) < p, b)
                for shape, p, b in cases]
    wants = [ck.compact_select_rayfold(v, b) for v, b in lattices]
    ck.compact_select_kernel(*lattices[0])
    torch.cuda.synchronize()
    key = (lattices[0][0].device.index, torch.cuda.current_stream().cuda_stream)
    buf = ck._SCRATCH[key]
    epoch = buf[-1].item() >> 32
    gots = [ck.compact_select_kernel(v, b) for v, b in lattices]
    torch.cuda.synchronize()
    assert ck._SCRATCH[key] is buf
    assert buf[-1].item() == (epoch + len(lattices)) << 32
    for (sel, kept), (want_sel, want_kept) in zip(gots, wants):
        assert torch.equal(sel, want_sel) and torch.equal(kept, want_kept)
    big = torch.rand((buf.numel() * ck.TILE // 1000, 1000), device="cuda",
                     generator=gen) < 0.2
    for v, b in ((big, 262144), lattices[4]):
        got = ck.compact_select_kernel(v, b)
        want = ck.compact_select_rayfold(v, b)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ck._SCRATCH[key] is not buf


@pytest.mark.parametrize("m,w,n_rows,bf16", [
    (20000, 256, 864, False), (100003, 256, 65536, False),
    (777, 30, 50, False), (5001, 256, 300, True),
    (300001, 4, 3000, False), (50000, 2, 700, True), (20001, 16, 900, False),
    (5003, 3, 40, False)])
def test_k3_matches_plain(m, w, n_rows, bf16):
    """Contended and sparse tables, a ragged M, W % 4 != 0 (the scalar
    kernel), bf16 rows, narrow rows (W <= 16, the narrow kernel); rows past
    the table are dropped, zero lanes and zero rows skipped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(m)
    rows = torch.randint(-2, n_rows + 3, (m,), device="cuda", generator=gen,
                         dtype=torch.int32)
    upd = torch.randn((m, w), device="cuda", generator=gen)
    upd = upd * (torch.rand((m, w), device="cuda", generator=gen) < 0.2)
    upd[::9] = 0
    if bf16:
        upd = upd.to(torch.bfloat16)
    want = sk.scatter_add_rows_plain(rows, upd, n_rows)
    sk.reset_counts()
    got = sk.scatter_add_rows(rows, upd, n_rows)
    torch.cuda.synchronize()
    assert sk.launches["scatter_add_rows"] == 1
    assert got.dtype == torch.float32 and got.shape == (n_rows, w)
    _close_to_scale(got, want)
    with pytest.raises(ValueError):
        sk.scatter_add_rows(rows.long(), upd, n_rows)


@pytest.mark.parametrize("w,bf16", [(2, False), (4, False), (3, True),
                                     (16, False), (30, False), (256, False)])
def test_k3_in_one_tile_equals_plain_on_cpu(w, bf16):
    """Every column layout of K3's reduce (narrow rows, the scalar and the
    float4 kernel) adds a row's entries in sorted order: with the whole
    input in one tile, equal bit for bit to the plain version on CPU copies
    (index_add_ in sorted order), and the same bits on three launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m, n_rows = 4099, 37
    gen = torch.Generator(device="cuda").manual_seed(w)
    rows = torch.randint(-1, n_rows + 1, (m,), device="cuda", generator=gen,
                         dtype=torch.int32)
    upd = torch.randn((m, w), device="cuda", generator=gen)
    if bf16:
        upd = upd.to(torch.bfloat16)
    want = sk.scatter_add_rows_plain(rows.cpu(), upd.cpu(), n_rows)
    runs = [sk._scatter_add_rows(rows, upd, n_rows, tile=m)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0].cpu(), want)
    assert all(torch.equal(r, runs[0]) for r in runs[1:])


@pytest.mark.parametrize("m,w,n_rows", [(20000, 32, 864 * 27),
                                         (777, 30, 50)])
def test_k3_adds_into_out(m, w, n_rows):
    """K3 given `out` (the 4D cell levels' resident buffer): added into,
    not zeroed first: out + the plain version's sums within 1e-5 of the
    largest entry, the buffer returned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(m)
    rows = torch.randint(-2, n_rows + 3, (m,), device="cuda", generator=gen,
                         dtype=torch.int32)
    upd = torch.randn((m, w), device="cuda", generator=gen)
    base = torch.randn((n_rows, w), device="cuda", generator=gen)
    want = base + sk.scatter_add_rows_plain(rows, upd, n_rows)
    out = base.clone()
    sk.reset_counts()
    assert sk.scatter_add_rows(rows, upd, n_rows, out=out) is out
    torch.cuda.synchronize()
    assert sk.launches["scatter_add_rows"] == 1
    _close_to_scale(out, want)


def test_keyframe_encoder_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = tbg.BrickGridSpec(n_levels=8, n_features=4, base_res=16,
                             max_res=512, log2_hashmap_size=16,
                             max_table_rows=2048, time_keyframes=4)
    rng = np.random.default_rng(7)
    n = 30011
    x = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    t[:8] = [[0], [1 / 3], [2 / 3], [1], [0.5], [1], [0], [0.25]]
    params = {k: rng.uniform(-1, 1, s).astype(np.float32)
              for k, s in spec.param_shapes()}
    g = torch.from_numpy(rng.normal(size=(n, spec.output_dim)).astype(
        np.float32))
    res = {}
    sk.reset_counts()
    for dev in ("cpu", "cuda"):
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        tt = torch.from_numpy(t).to(dev).requires_grad_(True)
        pt = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
              for k, v in params.items()}
        out = tbg.brick_encode(xt, pt, spec, t=tt)
        (out.float() * g.to(dev)).sum().backward()
        res[dev] = [out.detach().float().cpu(), xt.grad.cpu(), tt.grad.cpu()
                    ] + [pt[k].grad.cpu() for k in sorted(pt)]
    torch.cuda.synchronize()
    assert sk.launches["scatter_add_rows"] == spec.n_levels
    assert sk.plain_cuda_calls["scatter_add_rows"] == 0
    cpu, card = res["cpu"], res["cuda"]
    torch.testing.assert_close(card[0], cpu[0], rtol=2.0 ** -7, atol=1e-6)
    for a, b in zip(card[1:], cpu[1:]):
        _close_to_scale(a, b)


@pytest.mark.parametrize("n_feat,n,levels", [(4, 1001, 8), (2, 4099, 16),
                                             (1, 33, 3), (4, 20000, 4)])
@pytest.mark.parametrize("upd_dtype", [torch.float32, torch.bfloat16])
def test_k7_matches_plain(n_feat, n, levels, upd_dtype):
    x, _, _, feats, scales, nbs, _ = _cuda_inputs(4, n_feat, n, levels)
    gen = torch.Generator(device="cuda").manual_seed(4)
    g = torch.randn((n, levels * n_feat), device="cuda", generator=gen
                    ).to(torch.bfloat16)
    g[::7] = 0
    want_u, want_x = ek.interp_bwd_plain(x, g, feats, scales, nbs, n_feat,
                                         upd_dtype)
    ek.reset_counts()
    upd, d_x = ek.interp_bwd(x, g, feats, scales, nbs, n_feat, upd_dtype)
    torch.cuda.synchronize()
    assert ek.launches["interp_bwd"] == 1
    assert upd.dtype == upd_dtype and upd.shape == want_u.shape
    for l in range(levels):
        _close_to_scale(upd[l].float(), want_u[l].float())
    _close_to_scale(d_x, want_x)
    with pytest.raises(ValueError):
        ek.interp_bwd(x, g.float(), feats, scales, nbs, n_feat)


@pytest.mark.parametrize("dtype,w,n", [
    (torch.bfloat16, 128, 100003), (torch.bfloat16, 256, 4099),
    (torch.bfloat16, 100, 777), (torch.float32, 256, 5000),
    (torch.float32, 37, 333), (torch.bfloat16, 8, 1001)])
def test_k8_matches_plain(dtype, w, n):
    """512- and 256-byte rows, 1 KB f32 rows (a group loops over the row's
    words), rows that are not a multiple of 16 bytes (the scalar kernel),
    16-byte rows; ragged N, indices out of range; every rows_in_flight."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(w)
    r = 3000
    table = torch.randn((r, w), device="cuda", generator=gen).to(dtype)
    idx = torch.randint(-3, r + 3, (n,), device="cuda", generator=gen,
                        dtype=torch.int32)
    want = gk.row_gather_plain(table, idx)
    bits = {2: torch.int16, 4: torch.int32}[table.element_size()]
    for rif in gk.ROWS_IN_FLIGHT:
        gk.reset_counts()
        got = gk.row_gather(table, idx, rif)
        torch.cuda.synchronize()
        assert gk.launches["row_gather"] == 1
        assert torch.equal(got.view(bits), want.view(bits)), rif
    with pytest.raises(ValueError):
        gk.row_gather(table, idx.long())
