"""The CUDA kernels K1, K5, K6, K6c, K2, K4, K3, K7 and K8 against their plain
versions, K4's cached scratch across calls, and the 4D keyframe encoder
(whose backward runs K3) against the CPU, on the card.

Marked `gpu`: without a CUDA card every test here skips. This file imports
neither jax nor the JAX package, so it runs on a machine that has only the
port's dependencies; there, skip the suite's JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: f32 output rtol 1e-5, atol 1e-9 (summation order only, at the
+-1e-4 table scale); bf16 output one bf16 rounding, rtol 2^-7. Backward
kernels (K6, K2: one kernel body, on the table or on the gathered rows):
their f32 atomics add in another order than the plain version's index_add,
so each gradient is held to 1e-5 of its largest entry (plus rtol 1e-5);
K2's d_x, summed in level order, is bit-equal across two launches. K4
(compaction) is integer work: bit-exact. K3 (row scatter-add) sums with
f32 atomics against index_add's order: 1e-5 of the largest entry, as K6.
The 4D encoder on the card against the CPU: the
forward is the same PyTorch code on both (bf16 out, rtol 2^-7: one bf16
rounding of f32 sums taken in another order); its gradients 1e-5 of each
array's largest entry (K3's atomics, and the reductions' order). K7
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


@pytest.mark.parametrize("n_feat,n,levels,points", [
    (4, 1001, 8, None), (2, 4099, 16, None), (1, 33, 3, None),
    (4, 20000, 4, None), (4, 101, 8, "cells"), (2, 77, 5, "cells"),
    (1, 5, 3, "cells"), (4, 20000, 8, "one brick"),
    (2, 4097, 3, "one brick"), (4, 20000, 8, "ray major"),
    (1, 4099, 5, "ray major")])
def test_backward_kernels_match_plain(n_feat, n, levels, points):
    """K6 and K2 (one kernel body) against K6's plain version; "cells" as
    in test_kernels_match_plain, "one brick" puts every sample into one
    level-0 brick (the most contended table gradient), "ray major" gives
    large and mixed match groups."""
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


@pytest.mark.parametrize("n_feat,n,levels,points", [
    (4, 1001, 8, None), (2, 4099, 8, None), (1, 33, 3, None),
    (4, 101, 8, "cells"), (4, 20000, 8, "one brick"),
    (4, 20000, 8, "ray major")])
def test_k6c_matches_plain(n_feat, n, levels, points):
    """K6c (the cell layouts' backward) against its plain version, the
    hashed levels on the per-cell target and the dense ones on K6's: each
    array within 1e-5 of its largest entry, as K6 (the same bf16 terms,
    f32 atomics in another order)."""
    x, table, rows, feats, scales, nbs, level_rows = _cuda_inputs(
        3, n_feat, n, levels, points)
    spec = tbg.BrickGridSpec(n_levels=levels, n_features=n_feat,
                             base_res=16, max_res=512, log2_hashmap_size=16,
                             max_table_rows=2048)
    offs, off = [], 0
    for lay in spec.level_layout():
        offs.append(off if lay["hashed"] else -1)
        off += 27 * lay["rows"] if lay["hashed"] else 0
    assert off > 0
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = torch.randn((x.shape[0], levels * n_feat), device="cuda",
                    generator=gen).to(torch.bfloat16)
    g[::7] = 0
    args = (x, g, rows, table, scales, nbs, level_rows, n_feat, offs)
    want = ek.fused_encode_bwd_cell_plain(*args)
    got = ek.fused_encode_bwd_cell(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _close_to_scale(a, b)


@pytest.mark.parametrize("n_feat,points", [(4, "ray major"), (2, None)])
def test_k2_d_x_is_deterministic(n_feat, points):
    """d_x is summed over the levels in level order, so two launches of K2
    give the same bits (only the table gradient's atomics add in another
    order from run to run)."""
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
    (777, 30, 50, False), (5001, 256, 300, True)])
def test_k3_matches_plain(m, w, n_rows, bf16):
    """Contended and sparse tables, a ragged M, W % 4 != 0 (the scalar
    kernel), bf16 rows; rows past the table are dropped, zero lanes and
    zero rows skipped."""
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
