"""The fixed-order sums of the port's train step against the JAX package.

  * the plain ordered reduce of the table gradient (ordered_reduce_plain,
    as table_reduce_plain and scatter_add_rows_plain run it): the K6 layout
    (L3 F4, dense and hashed levels), the K6c cell layout and K3's 4D
    keyframe rows, against JAX's `_scatter_rows` (impl "xla") and the
    Pallas `scatter_add_rows` in interpret mode; table_reduce_plain given a
    NaN-filled table gradient (the kernel's is allocated, not filled)
    writes every brick level's row, zero where no key lands;
  * the kernels' two levels: carry_plain (the folded carry's reference)
    adds a run across tile edges as its per-tile sums in tile order;
  * with many samples in one row, the plain ordered reduce equal bit for
    bit to CPU index_add_ (which adds in index order: the sorted order);
  * the exclusive row scan (exclusive_cumsum of a 1-D tensor, through
    row_cumsum) and its backward against jnp.cumsum(x) - x;
  * segment_broadcast with colliding starts (rays with no samples, a block
    that overflows) and its gradient against JAX's.

Tolerances. The ordered reduce and the scans sum in f32 in another order
than XLA's (and the one-hot and VMEM scatters'): each output is held to
1e-6 of a level's largest entry, a scan to 1e-6 of its running total's
largest magnitude. segment_broadcast telescopes f32 differences (atol 1e-5
on O(1) values, as tests/test_torch_packed.py holds it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cednerf_tpu.ops import brick_grid as jbg
from cednerf_tpu.ops import pallas_scatter as jps
from cednerf_tpu.ops import segments as js
from cednerf_torch.ops import brick_grid as tbg
from cednerf_torch.ops import encode_kernels as ek
from cednerf_torch.ops import scatter_kernels as sk
from cednerf_torch.ops import segments as ts
from cednerf_torch.utils.math import (exclusive_cumsum, fixed_cumsum,
                                      row_cumsum)

SPEC_KW = dict(n_levels=3, n_features=4, base_res=16, max_res=64,
               log2_hashmap_size=12, max_table_rows=256)
FRAC = 1e-6
N = 2048      # a multiple of the Pallas scatter's tile


def _close_to_scale(got, want, frac=FRAC, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= frac * scale + 1e-30, f"{name}: err {err} scale {scale}"


def _jax_sums(rows, upd, n_rows):
    """JAX's XLA scatter and the Pallas VMEM scatter (interpret mode) of
    upd [M, W] at rows [M]."""
    r, u = jnp.asarray(rows), jnp.asarray(upd)
    xla = jbg._scatter_rows(r, u, n_rows, jnp.float32, "xla")
    pallas = jps.scatter_add_rows(r, u, n_rows=n_rows,
                                  accum_dtype=jnp.float32, tile=1024,
                                  interpret=True)
    return np.asarray(xla), np.asarray(pallas)[:n_rows]


def _inputs(seed, inside=False):
    spec = tbg.BrickGridSpec(**SPEC_KW)
    rng = np.random.default_rng(seed)
    lo, hi = (0.0, 1.0) if inside else (-0.05, 1.05)
    x = torch.from_numpy(rng.uniform(lo, hi, (N, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(N, spec.n_levels * 4))
                         .astype(np.float32)).to(torch.bfloat16)
    g[::7] = 0          # unused budget slots
    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    rows = torch.stack([tbg._level_geom(x, scales[i], nbs[i], l["hashed"],
                                        l["rows"])[0]
                        for i, l in enumerate(lay)])
    return spec, x, g, rows, scales, nbs, level_rows


def test_spec_has_dense_and_hashed_levels():
    hashed = [l["hashed"] for l in tbg.BrickGridSpec(**SPEC_KW).level_layout()]
    assert not all(hashed) and any(hashed)


def test_k6_layout_reduce_matches_jax():
    """table_reduce_plain on K6's keys (offset_l + r, INT_MAX for a zero
    cotangent) against JAX's scatters of the same update rows, level by
    level."""
    spec, x, g, rows, scales, nbs, level_rows = _inputs(11)
    offs = np.cumsum([0] + level_rows)
    zero = (g.float().view(N, len(scales), 4) == 0).all(-1).t()    # [L, N]
    keys = torch.where(zero, torch.iinfo(torch.int32).max,
                       rows + torch.tensor(offs[:-1])[:, None]).to(torch.int32)
    d_table = torch.full((offs[-1], 256), float("nan"))
    ek.table_reduce(keys, x, g, scales, nbs, level_rows, 4, d_table)
    hit = torch.zeros(offs[-1], dtype=torch.bool)
    hit[keys[keys < offs[-1]].long()] = True
    assert hit.any() and not hit.all()
    assert not d_table.isnan().any() and d_table[~hit].eq(0).all()
    for lvl in range(len(scales)):
        upd, _ = ek._bwd_rows(torch.zeros(N, 256), x,
                              g[:, lvl * 4:(lvl + 1) * 4], scales[lvl],
                              nbs[lvl], 4)
        got = d_table[offs[lvl]:offs[lvl + 1]].numpy()
        for want in _jax_sums(rows[lvl].numpy(), upd.numpy(),
                              level_rows[lvl]):
            _close_to_scale(got, want, name=f"level {lvl}")


def test_k6c_cell_layout_reduce_matches_jax():
    """The cell levels' keys (n_table + cell offset + r*27 + cell): the
    bf16-formed cell terms summed into [rows*27, 8F] against JAX's
    scatters of the same terms at the same cell rows; the brick level's
    rows as K6's."""
    spec, x, g, rows, scales, nbs, level_rows = _inputs(12, inside=True)
    lay = spec.level_layout()
    n_table = sum(level_rows)
    cell_rows, off = [], 0
    for l in lay:
        cell_rows.append(off if l["hashed"] else -1)
        off += 27 * l["rows"] if l["hashed"] else 0
    offs = np.cumsum([0] + level_rows)
    keys = []
    for lvl in range(len(scales)):
        if cell_rows[lvl] >= 0:
            cidx = ek.cell_index(x, scales[lvl], nbs[lvl])
            keys.append(n_table + cell_rows[lvl] + rows[lvl].long() * 27
                        + cidx)
        else:
            keys.append(rows[lvl].long() + int(offs[lvl]))
    keys = torch.stack(keys).to(torch.int32)
    d_table = torch.full((n_table, 256), float("nan"))
    d_cell = torch.zeros((off, 32), dtype=torch.float32)
    ek.table_reduce(keys, x, g, scales, nbs, level_rows, 4, d_table, d_cell,
                    cell_rows)
    # the brick level's rows all written; the cell levels' left to the fold
    brick = torch.repeat_interleave(torch.tensor([c < 0 for c in cell_rows]),
                                    torch.tensor(level_rows))
    assert not d_table[brick].isnan().any() and d_table[~brick].isnan().all()
    for lvl in range(len(scales)):
        gl = g[:, lvl * 4:(lvl + 1) * 4]
        if cell_rows[lvl] < 0:
            upd, _ = ek._bwd_rows(torch.zeros(N, 256), x, gl, scales[lvl],
                                  nbs[lvl], 4)
            got = d_table[offs[lvl]:offs[lvl + 1]].numpy()
            n_rows, k = level_rows[lvl], rows[lvl]
        else:
            upd = ek.cell_updates(x, gl, scales[lvl], nbs[lvl],
                                  True).reshape(N, 32)
            n_rows = 27 * level_rows[lvl]
            got = d_cell[cell_rows[lvl]:cell_rows[lvl] + n_rows].numpy()
            k = keys[lvl].long() - n_table - cell_rows[lvl]
        for want in _jax_sums(k.numpy().astype(np.int32), upd.numpy(),
                              n_rows):
            _close_to_scale(got, want, name=f"level {lvl}")


def test_k3_keyframe_rows_match_jax():
    """K3's plain version on one 4D level's keyframe-split update rows
    ([2N, 64F]: rows lo and lo + 1 of the keyframe view, 1 in 8 lanes
    nonzero) against JAX's scatters."""
    rng = np.random.default_rng(13)
    n_rows = 216 * 4
    lo = rng.integers(0, n_rows - 1, N)
    rows = np.concatenate([lo, lo + 1]).astype(np.int32)
    upd = (rng.normal(size=(2 * N, 256))
           * (rng.random((2 * N, 256)) < 0.125)).astype(np.float32)
    got = sk.scatter_add_rows(torch.from_numpy(rows), torch.from_numpy(upd),
                              n_rows)
    for want in _jax_sums(rows, upd, n_rows):
        _close_to_scale(got.numpy(), want)


@pytest.mark.parametrize("n_rows,hot", [(1, 1.0), (216, 0.9)])
def test_ordered_reduce_equals_index_add_bit_for_bit(n_rows, hot):
    """Many samples in one row (all of them, or 90% in row 0): the plain
    ordered reduce sums each row in sorted order, which is index_add_'s
    order of the unsorted keys on the CPU, bit for bit; and that order is
    the sequential one (a loop over the row's terms in input order)."""
    rng = np.random.default_rng(int(hot * 100) + n_rows)
    m = 20000
    keys = np.where(rng.random(m) < hot, 0, rng.integers(0, n_rows, m))
    keys = torch.from_numpy(keys.astype(np.int32))
    upd = torch.from_numpy(rng.normal(size=(m, 8)).astype(np.float32))
    got = sk.ordered_reduce_plain(keys, upd, n_rows)
    want = torch.zeros((n_rows, 8)).index_add_(0, keys.long(), upd)
    assert torch.equal(got, want)
    seq = torch.zeros(8)
    for i in np.flatnonzero(keys.numpy() == 0):
        seq = seq + upd[i]
    assert torch.equal(got[0], seq)
    out = torch.zeros((n_rows, 8))
    assert sk.scatter_add_rows(keys, upd, n_rows, out=out) is out
    assert torch.equal(out, want)


def _tile_partials(keys, upd, tile, n_keys):
    """The reduce kernel's partial rows, emulated: [2, tiles, W] (heads,
    then tails) of each tile's first run that began in an earlier tile and
    last run that goes on past it, each summed in sorted order."""
    k = keys.long()
    e, w = k.numel(), upd.shape[1]
    tiles = -(-e // tile)
    part = torch.full((2, tiles, w), float("nan"))
    for t in range(tiles):
        s, end = t * tile, min(t * tile + tile, e)
        seg = k[s:end]
        if s > 0 and seg[0] == k[s - 1]:
            run = seg == seg[0]
            part[0, t] = torch.zeros((1, w)).index_add_(
                0, torch.zeros(int(run.sum()), dtype=torch.long),
                upd[s:end][run])[0]
        if end < e and seg[-1] == k[end] and not (
                s > 0 and seg[0] == seg[-1] and seg[0] == k[s - 1]):
            run = seg == seg[-1]
            part[1, t] = torch.zeros((1, w)).index_add_(
                0, torch.zeros(int(run.sum()), dtype=torch.long),
                upd[s:end][run])[0]
    return part


def test_carry_plain_adds_crossing_runs_in_tile_order():
    """A key whose run lies in one tile has no partial; the carry's sums of
    the crossing runs (one across 5 tiles, one across an edge, one past
    the destination that is dropped) equal each run's tail + heads in
    tile order bit for bit, and its whole sum within 1e-6."""
    tile, n_keys = 64, 6
    counts = [10, 300, 20, 70, 3, 90]     # key 5 lies past the rows
    keys = torch.cat([torch.full((c,), i, dtype=torch.int32)
                      for i, c in enumerate(counts)])
    rng = np.random.default_rng(3)
    upd = torch.from_numpy(rng.normal(size=(keys.numel(), 8))
                           .astype(np.float32))
    part = _tile_partials(keys, upd, tile, n_keys)
    chained, sums = sk.carry_plain(keys, part, tile, n_keys - 1)
    whole = sk.ordered_reduce_plain(keys, upd, n_keys)
    assert chained.tolist() == [1, 2, 3]
    for key, got in zip(chained.tolist(), sums):
        tiles = sorted({int(i) // tile for i in
                        np.flatnonzero(keys.numpy() == key)})
        want = part[1, tiles[0]].clone()
        for u in tiles[1:]:
            want = want + part[0, u]
        assert torch.equal(got, want)
        _close_to_scale(got.numpy(), whole[key].numpy())


def _sorted_terms(keys, terms, n_keys):
    """keys [E] and terms [E, W] in key_sort's order (keys outside
    [0, n_keys) as n_keys, last)."""
    k, perm = sk.key_sort_plain(keys.reshape(-1), n_keys)
    return k, terms[perm.long()]


def _tile_order_sums(keys, terms, tile, n_keys):
    """The folded carry's order stated directly on sorted keys [E] and
    their terms [E, W]: for each key in [0, n_keys) whose entries lie in
    more than one tile of `tile`, its entries in each tile added in sorted
    order from 0, and those sums added in tile order. {key: row}."""
    k = keys.long()
    sums = {}
    for key in torch.unique(k[(k >= 0) & (k < n_keys)]).tolist():
        idx = torch.nonzero(k == key)[:, 0]
        tiles = idx // tile
        if tiles[0] == tiles[-1]:
            continue
        row = None
        for t in torch.unique(tiles).tolist():
            acc = torch.zeros(terms.shape[1])
            for i in idx[tiles == t].tolist():
                acc = acc + terms[i]
            row = acc if row is None else row + acc
        sums[key] = row
    return sums


@pytest.mark.parametrize("kind,tile", [("k3", 64), ("k3", 1000),
                                       ("k6", 256), ("k6", 97)])
def test_folded_carry_order_equals_carry_plain(kind, tile):
    """carry_plain, which the reduce kernels' folded carry is held to bit
    for bit on the card (test_torch_kernels_gpu.py), adds a crossing run
    in the two-level order: over the tiles' partial rows it gives exactly
    the keys whose entries lie in more than one tile, each its entries'
    sorted-order sum within each tile added in tile order, bit for bit;
    with the other keys' strict sums that table stays within 1e-6 of the
    strict order's largest entry. K3's rows (many entries in two hot rows,
    keys out of range dropped) and K6's table gradient (written whole over
    a NaN-filled buffer, INT_MAX keys dropped)."""
    rng = np.random.default_rng(tile)
    if kind == "k3":
        n_keys, m = 300, 6000
        keys = np.where(rng.random(m) < 0.4, rng.integers(0, 2, m),
                        rng.integers(-2, n_keys + 2, m)).astype(np.int32)
        keys = torch.from_numpy(keys)
        terms = torch.from_numpy(rng.normal(size=(m, 8)).astype(np.float32))
        strict = sk.scatter_add_rows_plain(keys, terms, n_keys)
    else:
        spec, x, g, rows, scales, nbs, level_rows = _inputs(tile)
        offs = np.cumsum([0] + level_rows)
        n_keys = int(offs[-1])
        zero = (g.float().view(N, len(scales), 4) == 0).all(-1).t()
        keys = torch.where(zero, torch.iinfo(torch.int32).max,
                           rows + torch.tensor(offs[:-1])[:, None]).to(
                               torch.int32)
        strict = ek.table_reduce(keys, x, g, scales, nbs, level_rows, 4,
                                 torch.full((n_keys, 256), float("nan")))[0]
        assert not strict.isnan().any()
        terms = torch.cat([ek._bwd_rows(torch.zeros(N, 256), x,
                                        g[:, lvl * 4:(lvl + 1) * 4],
                                        scales[lvl], nbs[lvl], 4)[0]
                           for lvl in range(len(scales))])
    sk_keys, sk_terms = _sorted_terms(keys, terms, n_keys)
    part = _tile_partials(sk_keys, sk_terms, tile, n_keys)
    chained, sums = sk.carry_plain(sk_keys, part, tile, n_keys)
    want = _tile_order_sums(sk_keys, sk_terms, tile, n_keys)
    assert len(chained) > 0
    assert chained.tolist() == sorted(want)
    for key, row in zip(chained.tolist(), sums):
        assert torch.equal(row, want[key])
    folded = strict.clone()
    folded[chained] = sums
    _close_to_scale(folded.numpy(), strict.numpy())


@pytest.mark.parametrize("n", [2, 1000, 1024, 3001, 70000])
def test_exclusive_row_scan_matches_jax(n):
    """exclusive_cumsum of a 1-D tensor (row_cumsum: rows of 1,024 and the
    row totals' prefix) and its backward (reversed row scans) against
    jnp.cumsum(x) - x and its vjp."""
    rng = np.random.default_rng(n)
    x = rng.uniform(0.0, 2.0, n).astype(np.float32)
    ct = rng.normal(size=n).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jnp.cumsum(v) - v, jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = exclusive_cumsum(xt, dim=0)
    got.backward(torch.from_numpy(ct))
    _close_to_scale(got.detach().numpy(), np.asarray(want))
    tot = np.abs(np.cumsum(ct[::-1])).max()
    err = np.abs(xt.grad.numpy() - np.asarray(want_g)).max()
    assert err <= FRAC * tot, (err, tot)
    # first made under inference_mode (an eval render), the scan's cached
    # block matrix still serves a scan that autograd records
    with torch.inference_mode():
        row_cumsum(torch.from_numpy(x) + 1.0)
    xt2 = torch.from_numpy(x + 1.0).requires_grad_(True)
    row_cumsum(xt2).sum().backward()
    assert xt2.grad is not None
    # a [1, n] row scans the same way; a [2, n] batch is torch.cumsum's
    row = fixed_cumsum(torch.from_numpy(x)[None], dim=1)
    assert torch.equal(row[0], fixed_cumsum(torch.from_numpy(x), dim=0))
    two = torch.from_numpy(np.stack([x, x]))
    assert torch.equal(fixed_cumsum(two, dim=1), torch.cumsum(two, dim=1))


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_segment_broadcast_colliding_starts_matches_jax(n_blocks):
    """Half the rays have no samples, so runs of rays share a start, and
    the counts overflow the budget, so rays pile onto the blocks' spill
    slots: values and the gradient of a masked objective against JAX's
    segment_broadcast (which adds the colliding differences), 1-D and
    [R, C]."""
    from cednerf_tpu.engine import renderer as jr
    from cednerf_torch.engine import renderer as tr

    rng = np.random.default_rng(21 + n_blocks)
    r, budget = 96, 256
    counts = np.where(rng.random(r) < 0.5, 0,
                      rng.integers(1, 16, r)).astype(np.int32)
    counts[:3] = 0
    starts = np.array(jr._block_starts(jnp.asarray(counts), budget,
                                       n_blocks))
    assert len(np.unique(starts)) < r // 2
    st = torch.from_numpy(starts)
    assert torch.equal(tr._block_starts(torch.from_numpy(counts), budget,
                                        n_blocks), st.long())
    mask = rng.random(budget) < 0.7
    for shape in ((r,), (r, 3)):
        v = rng.normal(size=shape).astype(np.float32)
        w = rng.normal(size=(budget,) + shape[1:]).astype(np.float32)
        w[~mask] = 0

        def jloss(vals):
            b = js.segment_broadcast(vals, jnp.asarray(starts), budget,
                                     n_blocks)
            return jnp.sum(jnp.asarray(w) * jnp.sin(b)), b

        (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(v))
        vt = torch.from_numpy(v).requires_grad_(True)
        got = ts.segment_broadcast(vt, st, budget, n_blocks)
        (torch.from_numpy(w) * torch.sin(got)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
        np.testing.assert_allclose(vt.grad.numpy(), np.asarray(want_g),
                                   atol=1e-5)
