"""The CUDA kernels K1 and K5 against their plain versions, on the card.

Marked `gpu`: without a CUDA card every test here skips. This file imports
neither jax nor the JAX package, so it runs on a machine that has only the
port's dependencies; there, skip the suite's JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: f32 output rtol 1e-5, atol 1e-9 (summation order only, at the
+-1e-4 table scale); bf16 output one bf16 rounding, rtol 2^-7.
"""

import numpy as np
import pytest
import torch

from cednerf_torch.ops import brick_grid as tbg
from cednerf_torch.ops import encode_kernels as ek

pytestmark = pytest.mark.gpu


def _cuda_inputs(seed, n_feat, n, levels):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = tbg.BrickGridSpec(n_levels=levels, n_features=n_feat, base_res=16,
                             max_res=512, log2_hashmap_size=16,
                             max_table_rows=2048)
    rng = np.random.default_rng(seed)
    lay = spec.level_layout()
    tables = [rng.uniform(-1e-4, 1e-4, (l["rows"], 64 * n_feat))
              .astype(np.float32) for l in lay]
    x = torch.from_numpy(rng.uniform(-0.05, 1.05, (n, 3)).astype(
        np.float32)).cuda()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    rows = torch.stack([tbg._level_geom(x, scales[i], nbs[i], l["hashed"],
                                        l["rows"])[0]
                        for i, l in enumerate(lay)]).contiguous()
    table = torch.from_numpy(np.concatenate(tables)).to(torch.bfloat16).cuda()
    offs = np.cumsum([0] + level_rows)
    feats = torch.stack([table[offs[i]:offs[i + 1]][rows[i].long()]
                         for i in range(levels)]).contiguous()
    return x, table, rows, feats, scales, nbs, level_rows


@pytest.mark.parametrize("n_feat,n,levels", [(4, 1001, 8), (2, 4099, 16),
                                             (1, 33, 3)])
def test_kernels_match_plain(n_feat, n, levels):
    x, table, rows, feats, scales, nbs, level_rows = _cuda_inputs(
        0, n_feat, n, levels)
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
