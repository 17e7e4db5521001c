"""Brick-encoder kernels K1, K5 (forward) and K6, K2, K7 (backward), and
their plain versions.

  * `interp_fwd` (K1) — trilinear interpolation of pre-gathered brick rows,
    all levels in one launch. Replaces cednerf_tpu/ops/pallas_encoder.py
    `_build_fwd` / `interp_fwd`.
  * `fused_encode_fwd` (K5) — the same with the row gather inside the kernel.
    Replaces cednerf_tpu/ops/pallas_fused.py `_build_fused_fwd` /
    `fused_encode_fwd`. It is the CUDA route of `brick_encode`.
  * `fused_encode_bwd` (K6) — K5's backward: table and position gradients,
    re-gathering the rows from the table. Replaces pallas_fused.py
    `_build_fused_bwd` / `fused_encode_bwd` (one level per call there, all
    levels in one launch here). Two parts: a kernel that writes d_x and one
    key a (sample, level), then `table_reduce`.
  * `table_reduce` — the table gradient of K6, K6c and K2 summed in a fixed
    order, so that a backward gives the same bits on every run as the
    TPU's does: the keys sorted stably (scatter_kernels.key_sort, the
    kernel of csrc/key_sort.cuh, from this library), the terms summed by
    key in sorted order by the reduce kernel, the partial rows of keys
    that cross a tile edge by its carry pass (csrc/ordered_reduce.cuh). It
    replaces no TPU kernel: on the TPU the backward kernels sum in one
    order by walking the sample tiles on one core.
  * `fused_encode_bwd_cell` (K6c) — K6 for the cell row layouts: the levels
    the caller names accumulate their table gradient per (brick row, cell)
    into [rows*27, 8F] f32, the buffer that the JAX package's cell levels
    scatter into (cednerf_tpu/ops/brick_grid.py `_make_level_encode_cell`,
    `_scatter_rows`, whose "pallas" route is pallas_scatter.py
    `scatter_add_rows`); the other levels keep K6's brick target. The
    wrapper then folds the cell rows (fold_cells) and returns the table
    gradient: it is the cell layouts' 3D backward (ops/brick_grid.py). On
    CUDA the cell rows go into a buffer that stays resident and all zero
    between calls (`cell_buffer`).
  * `fold_cells` — the cell rows rounded and folded onto the brick corners
    with JAX's rounding points (the transpose of cednerf_tpu/ops/
    brick_grid.py `_expand_cell_table`, an XLA dot there), written into
    the cell levels' rows of the table gradient; it writes zeros back over
    the cell rows it read. The 4D cell route folds K3's cell rows with it.
  * `interp_bwd_fused` (K2) — K1's backward, given the gathered rows.
    Replaces pallas_encoder.py `_build_bwd_fused` / `interp_bwd_fused`.
  * `interp_bwd` (K7) — K1's backward that returns every level's update
    rows [L, N, 64F] and d_x instead of a table gradient; the caller
    scatters the rows (K3, ops/scatter_kernels.py). Replaces
    pallas_encoder.py `_build_bwd` / `interp_bwd`. No model path runs it
    (the JAX package never wired it either); this package's encoder probe
    tools/profile_interp_enc.py does.

The forward kernels live in csrc/brick_encode_fwd.cu and the backward ones
in csrc/brick_encode_bwd.cu, each built by nvcc for sm_90a the first time
one of its kernels is called (ops/cuda_build.py) and bound through ctypes.
A wrapper given CPU tensors runs the plain version, the same function
written in plain PyTorch (gather, compare-built lane weights, multiply, sum,
index_add, which on the CPU adds in index order: the sorted order of the
reduce); given CUDA tensors it launches the kernel or raises. Nothing
falls back. No backward kernel adds floats with atomics.

`launches` counts kernel launches per wrapper and `plain_cuda_calls` counts
plain-version calls on CUDA tensors (which only a kernel-versus-plain check
makes), so a run can show which route the main path took.
"""

import ctypes
from typing import Sequence

import numpy as np
import torch

from .cuda_build import KernelLibrary
from .scatter_kernels import (REDUCE_TILE, bind_key_sort, carry_plain,
                              key_sort, ordered_reduce_plain)

BRICK_CELLS = 3          # cells per brick edge
BRICK_CORNERS = 4        # corners per brick edge
CORNERS_PER_BRICK = 64   # 4^3
CELLS_PER_BRICK = 27     # 3^3
CELL_CORNERS = 8
MAX_LEVELS = 16          # kMaxLevels in the CUDA sources
KERNEL_FEATURES = (1, 2, 4)

_NAMES = ("interp_fwd", "fused_encode_fwd", "fused_encode_bwd",
          "fused_encode_bwd_cell", "fold_cells", "interp_bwd_fused",
          "interp_bwd", "table_reduce", "table_carry")
launches = dict.fromkeys(_NAMES, 0)
plain_cuda_calls = dict.fromkeys(_NAMES, 0)


def reset_counts():
    for d in (launches, plain_cuda_calls):
        for k in d:
            d[k] = 0


# --------------------------------------------------------------------- #
# Build and binding

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _bind_fwd(lib):
    lib.brick_fused_encode_fwd.argtypes = [_P, _P, _P, _I32, _I64, _I32, _P,
                                           _P, _P, _P, _I32, _P]
    lib.brick_fused_encode_fwd.restype = _I32
    lib.brick_interp_fwd.argtypes = [_P, _P, _I32, _I64, _I32, _P, _P, _P,
                                     _I32, _P]
    lib.brick_interp_fwd.restype = _I32


def _bind_bwd(lib):
    for fn in (lib.brick_fused_encode_bwd, lib.brick_interp_bwd_fused):
        fn.argtypes = [_P, _P, _P, _P, _I32, _I64, _I32, _P, _P, _P, _I64,
                       _P, _P, _P]
        fn.restype = _I32
    lib.brick_fused_encode_bwd_cell.argtypes = [
        _P, _P, _P, _P, _I32, _I64, _I32, _P, _P, _P, _P, _I64, _P, _P, _P]
    lib.brick_fused_encode_bwd_cell.restype = _I32
    lib.brick_table_reduce.argtypes = [_P, _P, _I64, _I32, _P, _P, _I32,
                                       _I64, _I32, _P, _P, _P, _I64, _P,
                                       _I64, _P, _P]
    lib.brick_table_reduce.restype = _I32
    lib.brick_table_carry.argtypes = [_P, _I64, _I32, _P, _P, _I64, _P,
                                      _I64, _I32, _P]
    lib.brick_table_carry.restype = _I32
    lib.brick_fold_cells.argtypes = [_P, _P, _I32, _P, _P, _P, _I32, _I32,
                                     _I32, _P]
    lib.brick_fold_cells.restype = _I32
    lib.brick_interp_bwd.argtypes = [_P, _P, _P, _I32, _I64, _I32, _P, _P, _P,
                                     _I32, _P, _P]
    lib.brick_interp_bwd.restype = _I32
    bind_key_sort(lib)


_FWD = KernelLibrary("brick_encode_fwd", _bind_fwd)
_BWD = KernelLibrary("brick_encode_bwd", _bind_bwd)


def _level_arrays(scales, nbs, level_rows=None):
    n = len(scales)
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"kernels take 1..{MAX_LEVELS} levels, got {n}")
    sc = (ctypes.c_float * n)(*[float(np.float32(s)) for s in scales])
    nb = (ctypes.c_int * n)(*[int(b) for b in nbs])
    rows = None if level_rows is None else (ctypes.c_int * n)(
        *[int(r) for r in level_rows])
    return sc, nb, rows


def _check_cuda_inputs(name, x, data, n_feat, out_dtype):
    if n_feat not in KERNEL_FEATURES:
        raise ValueError(f"{name}: kernel takes n_feat in {KERNEL_FEATURES}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: out_dtype must be bfloat16 or float32")
    if data.dtype != torch.bfloat16 or not data.is_contiguous():
        raise ValueError(f"{name}: brick rows must be contiguous bfloat16")
    if data.data_ptr() % 16:
        raise ValueError(f"{name}: brick rows must be 16-byte aligned")
    if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3
            or not x.is_contiguous()):
        raise ValueError(f"{name}: x must be contiguous float32 [N, 3]")
    if data.device != x.device:
        raise ValueError(f"{name}: inputs on different devices")


# --------------------------------------------------------------------- #
# Plain versions (shared lane math)


def cell_geom(x_a: torch.Tensor, scale: float, nb: int):
    """One level's cell geometry from coordinates x_a (any shape, f32).

    Returns (cell_raw int64, cell int64, intra int64, frac f32).
    pos = x*scale + 0.5 is rounded to f32 once: the product of the two f32
    values (the scale rounded to f32 first, as jnp.float32(scale)) is exact
    in f64 and the sum is rounded in f64, then to f32. That is the f32 FMA
    that the JAX encoder computes under jit (XLA contracts its multiply-add)
    up to double rounding at an exact f32 midpoint, and the kernels compute
    it the same way in f64, so their cells and the host's rows agree."""
    pos = (x_a.double() * float(np.float32(scale)) + 0.5).float()
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    hi = nb * BRICK_CELLS - 1
    # bounded before the int cast so far-out points stay well defined; the
    # clamp keeps every comparison against [0, hi] as it was
    cell_raw = pos_grid.clamp(-1, hi + 1).to(torch.int64)
    cell = cell_raw.clamp(0, hi)
    intra = cell - (cell // BRICK_CELLS) * BRICK_CELLS
    return cell_raw, cell, intra, frac


def lane_weights(intra: torch.Tensor, frac: torch.Tensor, n_feat: int):
    """[N, 64F] f32 corner weights at row width, compare-built per axis
    (lane = corner*F + f, corner = dx*16 + dy*4 + dz)."""
    corner = torch.arange(CORNERS_PER_BRICK * n_feat,
                          device=intra.device) // n_feat
    w = None
    for a in range(3):
        k = (corner // BRICK_CORNERS ** (2 - a)) % BRICK_CORNERS
        ia = intra[:, a:a + 1]
        fa = frac[:, a:a + 1].float()
        wa = torch.where(k == ia, 1.0 - fa,
                         torch.where(k == ia + 1, fa, torch.zeros_like(fa)))
        w = wa if w is None else w * wa
    return w


def _interp_rows(vals, x, scale, nb, n_feat):
    """Gathered rows [N, 64F] -> [N, F] f32 for one level."""
    _, _, intra, frac = cell_geom(x, scale, nb)
    prod = vals.float() * lane_weights(intra, frac, n_feat)
    return prod.reshape(-1, CORNERS_PER_BRICK, n_feat).sum(dim=1)


def interp_fwd_plain(x, feats, scales: Sequence[float], nbs: Sequence[int],
                     n_feat: int, out_dtype=torch.bfloat16):
    """Plain K1: feats [L, N, 64F] (or a list of L [N, 64F]) -> [N, L*F]."""
    if x.is_cuda:
        plain_cuda_calls["interp_fwd"] += 1
    outs = [_interp_rows(feats[lvl], x, scales[lvl], nbs[lvl], n_feat)
            for lvl in range(len(scales))]
    return torch.cat(outs, dim=-1).to(out_dtype)


def fused_encode_fwd_plain(x, table, rows, scales: Sequence[float],
                           nbs: Sequence[int], level_rows: Sequence[int],
                           n_feat: int, out_dtype=torch.bfloat16):
    """Plain K5: gather + K1. table [sum R_l, 64F] with the levels
    concatenated in order; rows [L, N] level-local row indices, each
    clamped into its level as the kernel clamps it."""
    if x.is_cuda:
        plain_cuda_calls["fused_encode_fwd"] += 1
    outs, off = [], 0
    for lvl in range(len(scales)):
        vals = table[off:off + level_rows[lvl]].index_select(
            0, rows[lvl].long().clamp(0, level_rows[lvl] - 1))
        outs.append(_interp_rows(vals, x, scales[lvl], nbs[lvl], n_feat))
        off += level_rows[lvl]
    return torch.cat(outs, dim=-1).to(out_dtype)


def _axis_lane_weights(x, scale, nb, n_feat):
    """One level's per-axis lane weights [N, 64F] f32, their d/dfrac signs
    and the edge gate ok [N, 3]."""
    cell_raw, _, intra, frac = cell_geom(x, scale, nb)
    hi = nb * BRICK_CELLS - 1
    ok = ((cell_raw >= 0) & (cell_raw <= hi)).float()
    corner = torch.arange(CORNERS_PER_BRICK * n_feat,
                          device=x.device) // n_feat
    ws, dws = [], []
    for a in range(3):
        k = (corner // BRICK_CORNERS ** (2 - a)) % BRICK_CORNERS
        ia, fa = intra[:, a:a + 1], frac[:, a:a + 1]
        lo, up = k == ia, k == ia + 1
        zero = torch.zeros_like(fa)
        ws.append(torch.where(lo, 1.0 - fa, torch.where(up, fa, zero)))
        dws.append(up.float() - lo.float())
    return ws, dws, ok


def _bwd_rows(vals, x, g, scale, nb, n_feat):
    """One level's backward from its rows [N, 64F] and cotangent g [N, F]:
    (update rows [N, 64F] f32 = w * g, d_x [N, 3] f32 scaled and
    edge-gated). The products are taken in the kernels' order: w = wx *
    (wy * wz), and d w / d frac_a = +-(the other two axes' weights)."""
    ws, dws, ok = _axis_lane_weights(x, scale, nb, n_feat)
    gout = g.float().repeat(1, CORNERS_PER_BRICK)          # lane c*F+f: g[f]
    upd = (ws[0] * (ws[1] * ws[2])) * gout
    h = vals.float() * gout
    d = [(h * (dws[0] * (ws[1] * ws[2]))).sum(-1),
         (h * (dws[1] * (ws[0] * ws[2]))).sum(-1),
         (h * (dws[2] * (ws[0] * ws[1]))).sum(-1)]
    d_x = torch.stack(d, dim=-1) * ok * float(np.float32(scale))
    return upd, d_x


def _encode_bwd_plain(x, g, rows, level_vals, level_rows, scales, nbs,
                      n_feat):
    d_table = torch.zeros((sum(level_rows), CORNERS_PER_BRICK * n_feat),
                          dtype=torch.float32, device=x.device)
    d_x = torch.zeros((x.shape[0], 3), dtype=torch.float32, device=x.device)
    off = 0
    for lvl in range(len(scales)):
        r = rows[lvl].long().clamp(0, level_rows[lvl] - 1)
        upd, dx = _bwd_rows(level_vals(lvl, off, r), x,
                            g[:, lvl * n_feat:(lvl + 1) * n_feat],
                            scales[lvl], nbs[lvl], n_feat)
        d_table[off:off + level_rows[lvl]].index_add_(0, r, upd)
        d_x += dx
        off += level_rows[lvl]
    return d_table, d_x


def fused_encode_bwd_plain(x, g, rows, table, scales: Sequence[float],
                           nbs: Sequence[int], level_rows: Sequence[int],
                           n_feat: int):
    """Plain K6: (d_table [sum R_l, 64F] f32, d_x [N, 3] f32) for the
    cotangent g [N, L*F] of fused_encode_fwd(x, table, rows, ...)."""
    if x.is_cuda:
        plain_cuda_calls["fused_encode_bwd"] += 1
    return _encode_bwd_plain(
        x, g, rows,
        lambda lvl, off, r: table[off:off + level_rows[lvl]].index_select(
            0, r),
        level_rows, scales, nbs, n_feat)


def cell_index(x, scale: float, nb: int) -> torch.Tensor:
    """[N] int64: the intra-brick cell (ix*3 + iy)*3 + iz of each point."""
    _, _, intra, _ = cell_geom(x, scale, nb)
    return (intra[:, 0] * BRICK_CELLS + intra[:, 1]) * BRICK_CELLS \
        + intra[:, 2]


def cell_updates(x, g, scale: float, nb: int, bf16_terms: bool):
    """[N, 8, F] f32: one level's update terms w_d * g of a cell row (d =
    dx*4 + dy*2 + dz), w_d = (wx * wy) * wz as the JAX cell levels form it.
    bf16_terms: in bf16 as a bf16 compute dtype forms them there (each axis
    weight bf16(frac) or bf16(1 - bf16(frac)), each product rounded),
    else in f32."""
    _, _, _, frac = cell_geom(x, scale, nb)
    d = torch.arange(CELL_CORNERS, device=x.device)
    bits = torch.stack([(d >> 2) & 1, (d >> 1) & 1, d & 1], dim=1) == 1
    dt = torch.bfloat16 if bf16_terms else torch.float32
    fa = frac.to(dt)[:, None, :]
    w3 = torch.where(bits, fa, 1.0 - fa)                           # [N, 8, 3]
    w = (w3[..., 0] * w3[..., 1]) * w3[..., 2]
    return (w[:, :, None] * g.to(dt)[:, None, :]).float()


def fused_encode_bwd_cell_plain(x, g, rows, table, scales: Sequence[float],
                                nbs: Sequence[int], level_rows: Sequence[int],
                                n_feat: int, cell_rows: Sequence[int],
                                bf16_terms: bool = True):
    """Plain K6c: (d_table [sum R_l, 64F] f32, d_cell [sum 27 R_l of the
    cell levels, 8F] f32, d_x [N, 3] f32). Level l adds its update terms
    (cell_updates) into d_cell from row cell_rows[l] (row + r*27 + cell,
    lane d*F + f) when cell_rows[l] >= 0, else into d_table as K6 does.
    The kernel forms the terms in bf16 (bf16_terms=True, the bf16 compute
    dtype it serves); bf16_terms=False is the f32 compute dtype's form."""
    if x.is_cuda:
        plain_cuda_calls["fused_encode_bwd_cell"] += 1
    n_cell = sum(27 * r for r, c in zip(level_rows, cell_rows) if c >= 0)
    d_table = torch.zeros((sum(level_rows), CORNERS_PER_BRICK * n_feat),
                          dtype=torch.float32, device=x.device)
    d_cell = torch.zeros((n_cell, CELL_CORNERS * n_feat), dtype=torch.float32,
                         device=x.device)
    d_x = torch.zeros((x.shape[0], 3), dtype=torch.float32, device=x.device)
    off = 0
    for lvl in range(len(scales)):
        r = rows[lvl].long().clamp(0, level_rows[lvl] - 1)
        vals = table[off:off + level_rows[lvl]].index_select(0, r)
        upd, dx = _bwd_rows(vals, x, g[:, lvl * n_feat:(lvl + 1) * n_feat],
                            scales[lvl], nbs[lvl], n_feat)
        if cell_rows[lvl] >= 0:
            cupd = cell_updates(x, g[:, lvl * n_feat:(lvl + 1) * n_feat],
                                scales[lvl], nbs[lvl], bf16_terms)
            crow = cell_rows[lvl] + r * CELLS_PER_BRICK + cell_index(
                x, scales[lvl], nbs[lvl])
            d_cell.index_add_(0, crow, cupd.reshape(x.shape[0], -1))
        else:
            d_table[off:off + level_rows[lvl]].index_add_(0, r, upd)
        d_x += dx
        off += level_rows[lvl]
    return d_table, d_cell, d_x


def table_reduce_plain(keys, x, g, scales: Sequence[float],
                       nbs: Sequence[int], n_feat: int, d_table,
                       d_cell=None):
    """Plain table_reduce: keys [L, N] (as K6's first part writes them) ->
    each (sample, level)'s table-gradient terms summed into row keys[l, i]
    of d_table [n_table, 64F] f32 (w * g, _bwd_rows' update row) or, for a
    key >= n_table, row keys[l, i] - n_table of d_cell [*, 8F] f32 (the
    bf16-formed cell terms, cell_updates); other keys dropped. Each row's
    terms are summed in stable sorted order (ordered_reduce_plain): one
    level's keys never meet another's, so that is ascending sample order.
    As the kernel does, the sum is stored over each row a key lands on;
    the other rows keep what they hold. Returns (d_table, d_cell)."""
    if x.is_cuda:
        plain_cuda_calls["table_reduce"] += 1
    n = x.shape[0]
    keys = keys.reshape(len(scales), n).long()
    n_table = d_table.shape[0]
    for lvl in range(len(scales)):
        gl = g[:, lvl * n_feat:(lvl + 1) * n_feat]
        ws, _, _ = _axis_lane_weights(x, scales[lvl], nbs[lvl], n_feat)
        upd = (ws[0] * (ws[1] * ws[2])) * gl.float().repeat(
            1, CORNERS_PER_BRICK)
        _store_sums(d_table, keys[lvl], upd)
        if d_cell is not None:
            cupd = cell_updates(x, gl, scales[lvl], nbs[lvl], True)
            _store_sums(d_cell, keys[lvl] - n_table, cupd.reshape(n, -1))
    return d_table, d_cell


def _store_sums(dst, keys, upd):
    """dst[k] = ordered_reduce_plain's sum of upd's rows at key k, for each
    key k in [0, len(dst)) that occurs."""
    hit = torch.unique(keys[(keys >= 0) & (keys < dst.shape[0])])
    dst[hit] = ordered_reduce_plain(keys, upd, dst.shape[0])[hit]


_FOLD = {}


def fold_index(device) -> torch.Tensor:
    """[64 * 8] int64: for each brick corner, the (cell*8 + d) slots of a
    brick's 27 cell rows that replicate it, in ascending cell order, padded
    to 8 with slot 216 (a zero slot); corner = (cx+dx)*16 + (cy+dy)*4 +
    (cz+dz), d = dx*4 + dy*2 + dz."""
    if device not in _FOLD:
        slots = [[] for _ in range(CORNERS_PER_BRICK)]
        for cell in range(CELLS_PER_BRICK):
            cx, cy, cz = cell // 9, (cell // 3) % 3, cell % 3
            for d in range(CELL_CORNERS):
                corner = ((cx + (d >> 2)) * BRICK_CORNERS + cy + ((d >> 1) & 1)
                          ) * BRICK_CORNERS + cz + (d & 1)
                slots[corner].append(cell * CELL_CORNERS + d)
        pad = CELLS_PER_BRICK * CELL_CORNERS
        idx = [s + [pad] * (CELL_CORNERS - len(s)) for s in slots]
        _FOLD[device] = torch.tensor(idx, dtype=torch.int64,
                                     device=device).reshape(-1)
    return _FOLD[device]


def _fold_rows(d_cell, n_feat, compute_dtype, accum_bf16):
    """One level's cell rows [rows*27, 8F] f32 -> brick rows [rows, 64F]
    f32 with JAX's rounding points: each cell sum rounded to the
    accumulator dtype and to the cell table's dtype (the compute dtype),
    each corner's <= 8 slots summed in f32 from 0 slot by slot (the zero
    pad slots last), the sum rounded to the compute dtype."""
    if accum_bf16:
        d_cell = d_cell.to(torch.bfloat16)
    rows = d_cell.shape[0] // CELLS_PER_BRICK
    d = d_cell.to(compute_dtype).float().view(
        rows, CELLS_PER_BRICK * CELL_CORNERS, n_feat)
    d = torch.cat([d, d.new_zeros(rows, 1, n_feat)], dim=1)
    slots = d.index_select(1, fold_index(d.device)).view(
        rows, CORNERS_PER_BRICK, CELL_CORNERS, n_feat)
    acc = torch.zeros_like(slots[:, :, 0])
    for s in range(CELL_CORNERS):
        acc = acc + slots[:, :, s]
    return acc.to(compute_dtype).float().view(rows, -1)


def _cell_spans(level_rows, cell_rows):
    """[(first table row, first cell row, rows)] of the cell levels."""
    spans, off = [], 0
    for r, c in zip(level_rows, cell_rows):
        if c >= 0:
            spans.append((off, int(c), int(r)))
        off += int(r)
    return spans


def fold_cells_plain(d_cell, d_table, level_rows: Sequence[int],
                     cell_rows: Sequence[int], n_feat: int, compute_dtype,
                     accum_bf16: bool):
    """Plain fold_cells: each level l with cell_rows[l] >= 0 gets its rows
    of d_table [sum R_l, 64F] f32 (from row sum(level_rows[:l])) folded
    from its cell rows d_cell[cell_rows[l]:][:27 R_l] (_fold_rows), which
    are then zeroed. Returns d_table."""
    if d_cell.is_cuda:
        plain_cuda_calls["fold_cells"] += 1
    for t0, c0, r in _cell_spans(level_rows, cell_rows):
        cells = d_cell[c0:c0 + CELLS_PER_BRICK * r]
        d_table[t0:t0 + r] = _fold_rows(cells, n_feat, compute_dtype,
                                        accum_bf16)
        cells.zero_()
    return d_table


def interp_bwd_fused_plain(x, g, feats, rows, scales: Sequence[float],
                           nbs: Sequence[int], level_rows: Sequence[int],
                           n_feat: int):
    """Plain K2: as fused_encode_bwd_plain, from the gathered rows
    feats [L, N, 64F] that interp_fwd read (rows [L, N] place the table
    gradient)."""
    if x.is_cuda:
        plain_cuda_calls["interp_bwd_fused"] += 1
    return _encode_bwd_plain(x, g, rows, lambda lvl, off, r: feats[lvl],
                             level_rows, scales, nbs, n_feat)


def interp_bwd_plain(x, g, feats, scales: Sequence[float], nbs: Sequence[int],
                     n_feat: int, upd_dtype=torch.float32):
    """Plain K7: (upd [L, N, 64F] in upd_dtype, d_x [N, 3] f32) for the
    cotangent g [N, L*F] of interp_fwd(x, feats, ...): level l's update
    rows w * g (_bwd_rows' f32 products, rounded once to upd_dtype) and
    d_x summed over the levels in level order."""
    if x.is_cuda:
        plain_cuda_calls["interp_bwd"] += 1
    L, n = len(scales), x.shape[0]
    upd = torch.empty((L, n, CORNERS_PER_BRICK * n_feat), dtype=upd_dtype,
                      device=x.device)
    d_x = torch.zeros((n, 3), dtype=torch.float32, device=x.device)
    for lvl in range(L):
        u, dx = _bwd_rows(feats[lvl], x, g[:, lvl * n_feat:(lvl + 1) * n_feat],
                          scales[lvl], nbs[lvl], n_feat)
        upd[lvl].copy_(u)
        d_x += dx
    return upd, d_x


# --------------------------------------------------------------------- #
# Wrappers: plain version on CPU tensors, kernel on CUDA tensors


def interp_fwd(x, feats, scales: Sequence[float], nbs: Sequence[int],
               n_feat: int, out_dtype=torch.bfloat16):
    """K1: x [N, 3] f32, feats [L, N, 64F] gathered brick rows -> [N, L*F].

    On CUDA, feats must be contiguous bfloat16."""
    if not x.is_cuda:
        return interp_fwd_plain(x, feats, scales, nbs, n_feat, out_dtype)
    _check_cuda_inputs("interp_fwd", x, feats, n_feat, out_dtype)
    n, L = x.shape[0], len(scales)
    if tuple(feats.shape) != (L, n, CORNERS_PER_BRICK * n_feat):
        raise ValueError(f"interp_fwd: feats {tuple(feats.shape)} != "
                         f"{(L, n, CORNERS_PER_BRICK * n_feat)}")
    out = torch.empty((n, L * n_feat), dtype=out_dtype, device=x.device)
    if n == 0:
        return out
    lib = _FWD.get()
    sc, nb, _ = _level_arrays(scales, nbs)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.brick_interp_fwd(x.data_ptr(), feats.data_ptr(), L, n, n_feat,
                              sc, nb, out.data_ptr(),
                              int(out_dtype == torch.float32), stream)
    _FWD.check(rc, "interp_fwd")
    launches["interp_fwd"] += 1
    return out


def fused_encode_fwd(x, table, rows, scales: Sequence[float],
                     nbs: Sequence[int], level_rows: Sequence[int],
                     n_feat: int, out_dtype=torch.bfloat16):
    """K5: x [N, 3] f32, table [sum R_l, 64F] (levels concatenated in order),
    rows [L, N] int32 level-local brick rows -> [N, L*F].

    On CUDA, table must be contiguous bfloat16 and rows contiguous int32.
    Both routes clamp each row index into its level, so an index out of
    range reads the level's first or last row on either."""
    if not x.is_cuda:
        return fused_encode_fwd_plain(x, table, rows, scales, nbs,
                                      level_rows, n_feat, out_dtype)
    _check_cuda_inputs("fused_encode_fwd", x, table, n_feat, out_dtype)
    n, L = x.shape[0], len(scales)
    if (rows.dtype != torch.int32 or tuple(rows.shape) != (L, n)
            or not rows.is_contiguous() or rows.device != x.device):
        raise ValueError("fused_encode_fwd: rows must be contiguous int32 "
                         f"[{L}, {n}] on {x.device}")
    if table.shape != (sum(level_rows), CORNERS_PER_BRICK * n_feat):
        raise ValueError(f"fused_encode_fwd: table {tuple(table.shape)} does "
                         f"not hold levels of {list(level_rows)} rows")
    out = torch.empty((n, L * n_feat), dtype=out_dtype, device=x.device)
    if n == 0:
        return out
    lib = _FWD.get()
    sc, nb, lr = _level_arrays(scales, nbs, level_rows)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.brick_fused_encode_fwd(rows.data_ptr(), x.data_ptr(),
                                    table.data_ptr(), L, n, n_feat, sc, nb,
                                    lr, out.data_ptr(),
                                    int(out_dtype == torch.float32), stream)
    _FWD.check(rc, "fused_encode_fwd")
    launches["fused_encode_fwd"] += 1
    return out


def _check_bwd_inputs(name, x, g, rows, src, src_shape, L, n_feat):
    """K6/K2/K7's input checks (rows None: K7, which places no rows)."""
    n = x.shape[0]
    if n_feat not in KERNEL_FEATURES:
        raise ValueError(f"{name}: kernel takes n_feat in {KERNEL_FEATURES}")
    if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3
            or not x.is_contiguous()):
        raise ValueError(f"{name}: x must be contiguous float32 [N, 3]")
    if (g.dtype != torch.bfloat16 or tuple(g.shape) != (n, L * n_feat)
            or not g.is_contiguous()):
        raise ValueError(f"{name}: g must be contiguous bfloat16 "
                         f"[{n}, {L * n_feat}]")
    if rows is not None and (rows.dtype != torch.int32
                             or tuple(rows.shape) != (L, n)
                             or not rows.is_contiguous()):
        raise ValueError(f"{name}: rows must be contiguous int32 [{L}, {n}]")
    if (src.dtype != torch.bfloat16 or tuple(src.shape) != src_shape
            or not src.is_contiguous() or src.data_ptr() % 16):
        raise ValueError(f"{name}: brick rows must be contiguous, 16-byte "
                         f"aligned bfloat16 {src_shape}")
    if not all(t.device == x.device for t in (g, src)) or (
            rows is not None and rows.device != x.device):
        raise ValueError(f"{name}: inputs on different devices")


def _table_carry(keys, part, tile: int, n_feat: int, d_table, d_cell=None):
    """table_reduce's carry pass alone (its second launch; the tests and
    chip_smoke.py call it alone, and on CPU tensors for its plain version's
    bits): keys [E] int32 sorted, part
    [2, ceil(E / tile), 64F] f32 the reduce kernel's partial rows (heads,
    then tails); each key whose run crosses a tile edge gets its row of
    d_table [n_table, 64F] (or, past n_table, of d_cell [*, 8F]) stored
    from them (carry_plain's sums in tile order). Returns (d_table,
    d_cell)."""
    n_table = d_table.shape[0]
    n_cell = 0 if d_cell is None else d_cell.shape[0]
    if not keys.is_cuda:
        chained, sums = carry_plain(keys, part, tile, n_table + n_cell)
        t = chained < n_table
        d_table[chained[t]] = sums[t]
        if d_cell is not None:
            d_cell[chained[~t] - n_table] = sums[~t][:, :CELL_CORNERS * n_feat]
        return d_table, d_cell
    lib = _BWD.get()
    rc = lib.brick_table_carry(
        keys.data_ptr(), keys.numel(), tile, part.data_ptr(),
        d_table.data_ptr(), n_table,
        None if d_cell is None else d_cell.data_ptr(), n_cell, n_feat,
        torch.cuda.current_stream(keys.device).cuda_stream)
    _BWD.check(rc, "table_carry")
    launches["table_carry"] += 1
    return d_table, d_cell


def table_reduce(keys, x, g, scales: Sequence[float], nbs: Sequence[int],
                 n_feat: int, d_table, d_cell=None):
    """The table gradient of K6, K6c and K2 from the keys [L, N] int32 that
    their first kernel wrote (offset_l + r; n_table + a cell row; INT_MAX
    for a zero cotangent), x [N, 3] f32 and g [N, L*F] bf16: each
    (sample, level)'s terms summed into d_table [n_table, 64F] f32 or
    d_cell [*, 8F] f32 (table_reduce_plain), which must be zero where a
    key lands (on CUDA each key's row is stored, not added); returns
    (d_table, d_cell).

    On CUDA the sum takes one order on every run: key_sort of the keys
    (a stable radix sort over the bits n_table + n_cell needs, an int32
    index; K6's INT_MAX keys sort last), then the reduce kernel (a warp a
    tile of REDUCE_TILE sorted entries, each run of a key summed in sorted
    order) and its carry pass (the partials of keys that cross a tile
    edge, in tile order); no atomics."""
    return _table_reduce(keys, x, g, scales, nbs, n_feat, d_table, d_cell)


def _table_reduce(keys, x, g, scales, nbs, n_feat: int, d_table,
                  d_cell=None, tile: int = REDUCE_TILE, part=None):
    """table_reduce; `tile` changes only where the sums split in two
    levels; `part`, a [2, ceil(L*N / tile), 64F] f32 buffer, keeps the
    reduce kernel's partial rows (for _table_carry alone)."""
    if not x.is_cuda:
        return table_reduce_plain(keys, x, g, scales, nbs, n_feat, d_table,
                                  d_cell)
    n, L = x.shape[0], len(scales)
    for name, t, w in (("d_table", d_table, CORNERS_PER_BRICK * n_feat),
                       ("d_cell", d_cell, CELL_CORNERS * n_feat)):
        if t is not None and (t.dtype != torch.float32 or t.dim() != 2
                              or t.shape[1] != w or not t.is_contiguous()
                              or t.device != x.device):
            raise ValueError(f"table_reduce: {name} must be contiguous "
                             f"float32 [*, {w}] on {x.device}")
    if (keys.dtype != torch.int32 or keys.numel() != L * n
            or not keys.is_contiguous() or keys.device != x.device):
        raise ValueError(f"table_reduce: keys must be contiguous int32 "
                         f"[{L}, {n}] on {x.device}")
    if (g.dtype != torch.bfloat16 or tuple(g.shape) != (n, L * n_feat)
            or not g.is_contiguous() or x.dtype != torch.float32
            or not x.is_contiguous()):
        raise ValueError("table_reduce: x must be contiguous float32 [N, 3] "
                         "and g contiguous bfloat16 [N, L*F]")
    if n == 0:
        return d_table, d_cell
    if tile < 1:
        raise ValueError(f"table_reduce: tile {tile}")
    n_cell = 0 if d_cell is None else d_cell.shape[0]
    skeys, perm = key_sort(keys.reshape(-1), d_table.shape[0] + n_cell, _BWD)
    e = L * n
    shape = (2, -(-e // tile), CORNERS_PER_BRICK * n_feat)
    if part is None:
        part = torch.empty(shape, dtype=torch.float32, device=x.device)
    elif (tuple(part.shape) != shape or part.dtype != torch.float32
          or not part.is_contiguous() or part.device != x.device):
        raise ValueError(f"table_reduce: part must be contiguous float32 "
                         f"{shape} on {x.device}")
    cell_ptr = None if d_cell is None else d_cell.data_ptr()
    lib = _BWD.get()
    sc, nb, _ = _level_arrays(scales, nbs)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.brick_table_reduce(
        skeys.data_ptr(), perm.data_ptr(), e, tile, x.data_ptr(),
        g.data_ptr(), L, n, n_feat, sc, nb, d_table.data_ptr(),
        d_table.shape[0], cell_ptr, n_cell, part.data_ptr(), stream)
    _BWD.check(rc, "table_reduce")
    launches["table_reduce"] += 1
    return _table_carry(skeys, part, tile, n_feat, d_table, d_cell)


def _launch_bwd(fn, name, x, g, rows, src, scales, nbs, level_rows, n_feat):
    """K6's or K2's first kernel (d_x and the keys), then table_reduce."""
    n, L = x.shape[0], len(scales)
    d_table = torch.zeros((sum(level_rows), CORNERS_PER_BRICK * n_feat),
                          dtype=torch.float32, device=x.device)
    d_x = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    if n == 0:
        return d_table, d_x
    keys = torch.empty((L, n), dtype=torch.int32, device=x.device)
    lib = _BWD.get()
    sc, nb, lr = _level_arrays(scales, nbs, level_rows)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, fn)(x.data_ptr(), g.data_ptr(), rows.data_ptr(),
                          src.data_ptr(), L, n, n_feat, sc, nb, lr,
                          sum(level_rows), keys.data_ptr(), d_x.data_ptr(),
                          stream)
    _BWD.check(rc, name)
    launches[name] += 1
    table_reduce(keys, x, g, scales, nbs, n_feat, d_table)
    return d_table, d_x


def fused_encode_bwd(x, g, rows, table, scales: Sequence[float],
                     nbs: Sequence[int], level_rows: Sequence[int],
                     n_feat: int):
    """K6: the backward of fused_encode_fwd. x [N, 3] f32, g [N, L*F]
    cotangent, rows [L, N] int32, table [sum R_l, 64F] -> (d_table
    [sum R_l, 64F] f32, d_x [N, 3] f32, summed over levels, scaled and
    edge-gated). On CUDA, g and table must be bfloat16 (the forward's
    dtypes); the table gradient is summed in a fixed order
    (table_reduce), so the result has the same bits on every run."""
    if not x.is_cuda:
        return fused_encode_bwd_plain(x, g, rows, table, scales, nbs,
                                      level_rows, n_feat)
    _check_bwd_inputs("fused_encode_bwd", x, g, rows, table,
                      (sum(level_rows), CORNERS_PER_BRICK * n_feat),
                      len(level_rows), n_feat)
    return _launch_bwd("brick_fused_encode_bwd", "fused_encode_bwd", x, g,
                       rows, table, scales, nbs, level_rows, n_feat)


# The resident cell-gradient buffers of the cell layouts' backward, one
# per (device, cell levels' rows, F): f32 [sum 27 R_l, 8F], all zero between
# calls. K6c (3D) or K3 (4D) adds into one and fold_cells zeroes what it
# reads, so no call allocates or fills it. They are used on PyTorch's
# current stream only (the stream the backward runs on), which keeps the
# zero-between-calls order; a caller that runs the cell backward on two
# streams at once must not share one. A fixed buffer is also what a
# captured CUDA graph replays. release_cell_buffers frees them.
_CELL_BUFFERS = {}


def cell_buffer(device, rows: Sequence[int], n_feat: int) -> torch.Tensor:
    """The resident cell-gradient buffer of (device, the cell levels' brick
    rows, F), allocated all zero at its first use. Whoever adds into it
    folds it (fold_cells, which zeroes it) before the next user, and
    zeroes it if that fails."""
    key = (torch.device(device), tuple(int(r) for r in rows), n_feat)
    if key not in _CELL_BUFFERS:
        _CELL_BUFFERS[key] = torch.zeros(
            (CELLS_PER_BRICK * sum(key[1]), CELL_CORNERS * n_feat),
            dtype=torch.float32, device=device)
    return _CELL_BUFFERS[key]


def cell_buffers():
    """The resident cell-gradient buffers allocated so far."""
    return list(_CELL_BUFFERS.values())


def release_cell_buffers():
    """Frees the resident cell-gradient buffers (the next cell backward
    allocates its buffer again)."""
    _CELL_BUFFERS.clear()


def _check_k6c(x, g, rows, table, level_rows, n_feat, cell_rows):
    """K6c's input checks; returns its cell levels' spans (_cell_spans)."""
    L = len(level_rows)
    _check_bwd_inputs("fused_encode_bwd_cell", x, g, rows, table,
                      (sum(level_rows), CORNERS_PER_BRICK * n_feat), L,
                      n_feat)
    if len(cell_rows) != L:
        raise ValueError("fused_encode_bwd_cell: one cell row offset a level")
    spans = _cell_spans(level_rows, cell_rows)
    off = 0
    for _, c, r in spans:
        if c != off:
            raise ValueError("fused_encode_bwd_cell: the cell levels' rows "
                             "must lie back to back in level order, got "
                             f"{list(cell_rows)}")
        off += CELLS_PER_BRICK * r
    return spans


def _launch_k6c(x, g, rows, table, scales, nbs, level_rows, n_feat,
                cell_rows, d_table, d_cell, d_x):
    """K6c into buffers the caller supplies: d_table [sum R_l, 64F] f32
    (the brick levels' rows), d_cell [sum 27 R_l over the cell levels, 8F]
    f32 (row cell_rows[l] + r*27 + cell, lane (dx*4 + dy*2 + dz)*F + f),
    each zero where a key lands, since table_reduce stores each key's row
    over it; d_x [N, 3] f32 (written): its first kernel, then
    table_reduce. CUDA tensors only; d_cell is zeroed if a launch
    fails."""
    _check_k6c(x, g, rows, table, level_rows, n_feat, cell_rows)
    L, n = len(level_rows), x.shape[0]
    if n == 0:
        return
    keys = torch.empty((L, n), dtype=torch.int32, device=x.device)
    lib = _BWD.get()
    sc, nb, lr = _level_arrays(scales, nbs, level_rows)
    cr = (ctypes.c_longlong * L)(*[int(c) for c in cell_rows])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    try:
        rc = lib.brick_fused_encode_bwd_cell(
            x.data_ptr(), g.data_ptr(), rows.data_ptr(), table.data_ptr(), L,
            n, n_feat, sc, nb, lr, cr, sum(level_rows), keys.data_ptr(),
            d_x.data_ptr(), stream)
        _BWD.check(rc, "fused_encode_bwd_cell")
        launches["fused_encode_bwd_cell"] += 1
        table_reduce(keys, x, g, scales, nbs, n_feat, d_table, d_cell)
    except BaseException:
        d_cell.zero_()
        raise


def fold_cells(d_cell, d_table, level_rows: Sequence[int],
               cell_rows: Sequence[int], n_feat: int, compute_dtype,
               accum_bf16: bool):
    """The cell levels' rows of the table gradient d_table [sum R_l, 64F]
    f32 from their cell rows d_cell [*, 8F] f32 (level l's from row
    cell_rows[l], -1 for a brick level, whose rows are left as they are),
    with JAX's rounding points (fold_cells_plain); the cell rows read are
    zeroed. One launch for every cell level. Returns d_table. On CUDA,
    d_cell and d_table must be contiguous float32 and compute_dtype
    bfloat16 or float32."""
    if not d_cell.is_cuda:
        return fold_cells_plain(d_cell, d_table, level_rows, cell_rows,
                                n_feat, compute_dtype, accum_bf16)
    if n_feat not in KERNEL_FEATURES:
        raise ValueError(f"fold_cells: kernel takes n_feat in "
                         f"{KERNEL_FEATURES}")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("fold_cells: compute_dtype must be bfloat16 or "
                         "float32")
    for name, t, w in (("d_cell", d_cell, CELL_CORNERS * n_feat),
                       ("d_table", d_table, CORNERS_PER_BRICK * n_feat)):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != w
                or not t.is_contiguous() or t.data_ptr() % 16
                or t.device != d_cell.device):
            raise ValueError(f"fold_cells: {name} must be contiguous, "
                             f"16-byte aligned float32 [*, {w}] on "
                             f"{d_cell.device}")
    if len(cell_rows) != len(level_rows):
        raise ValueError("fold_cells: one cell row offset a level")
    if d_table.shape[0] != sum(level_rows):
        raise ValueError(f"fold_cells: d_table has {d_table.shape[0]} rows, "
                         f"the levels {sum(level_rows)}")
    spans = _cell_spans(level_rows, cell_rows)
    if any(c + CELLS_PER_BRICK * r > d_cell.shape[0] for _, c, r in spans):
        raise ValueError("fold_cells: a cell level's rows lie past d_cell")
    if not spans:
        return d_table
    k = len(spans)
    if k > MAX_LEVELS:
        raise ValueError(f"fold_cells: kernel takes 1..{MAX_LEVELS} levels")
    arr = ctypes.c_longlong * k
    lib = _BWD.get()
    stream = torch.cuda.current_stream(d_cell.device).cuda_stream
    rc = lib.brick_fold_cells(
        d_cell.data_ptr(), d_table.data_ptr(), k,
        arr(*[r for _, _, r in spans]), arr(*[c for _, c, _ in spans]),
        arr(*[t for t, _, _ in spans]), n_feat, int(accum_bf16),
        int(compute_dtype == torch.bfloat16), stream)
    _BWD.check(rc, "fold_cells")
    launches["fold_cells"] += 1
    return d_table


def fused_encode_bwd_cell(x, g, rows, table, scales: Sequence[float],
                          nbs: Sequence[int], level_rows: Sequence[int],
                          n_feat: int, cell_rows: Sequence[int],
                          compute_dtype, accum_bf16: bool):
    """The cell layouts' backward: K6c (fused_encode_bwd with a per-cell
    target), then fold_cells over its cell rows. cell_rows [L]: level l's
    first row in the cell gradient (the cell levels' rows back to back, in
    level order), or -1 to keep K6's brick target. The cell levels' update
    terms w * g are formed in bf16 as the JAX cell levels form them at a
    bf16 compute dtype (cell_updates); on CUDA compute_dtype must be
    bfloat16 (the kernel reads bf16 rows).
    Returns (d_table [sum R_l, 64F] f32: the brick levels' f32 sums, the
    cell levels' folded values in the compute dtype; d_x [N, 3] f32).
    On CUDA the cell rows go into the resident buffer of (device, cell
    levels' rows, F), which the fold leaves all zero again (and which is
    zeroed if either step raises); d_table is filled only over the brick
    levels' rows, the fold writes the others."""
    if not x.is_cuda:
        d_table, d_cell, d_x = fused_encode_bwd_cell_plain(
            x, g, rows, table, scales, nbs, level_rows, n_feat, cell_rows,
            bf16_terms=compute_dtype == torch.bfloat16)
        return fold_cells(d_cell, d_table, level_rows, cell_rows, n_feat,
                          compute_dtype, accum_bf16), d_x
    if compute_dtype != torch.bfloat16:
        raise ValueError("fused_encode_bwd_cell: the kernel forms bf16 terms")
    spans = _check_k6c(x, g, rows, table, level_rows, n_feat, cell_rows)
    total = sum(level_rows)
    d_table = torch.empty((total, CORNERS_PER_BRICK * n_feat),
                          dtype=torch.float32, device=x.device)
    t = 0      # each run of adjacent brick levels' rows: the reduce adds
    for t0, _, r in spans + [(total, 0, 0)]:
        if t0 > t:
            d_table[t:t0].zero_()
        t = t0 + r
    d_cell = cell_buffer(x.device, [r for _, _, r in spans], n_feat)
    d_x = torch.empty((x.shape[0], 3), dtype=torch.float32, device=x.device)
    _launch_k6c(x, g, rows, table, scales, nbs, level_rows, n_feat,
                cell_rows, d_table, d_cell, d_x)
    try:
        fold_cells(d_cell, d_table, level_rows, cell_rows, n_feat,
                   compute_dtype, accum_bf16)
    except BaseException:
        d_cell.zero_()
        raise
    return d_table, d_x


def interp_bwd_fused(x, g, feats, rows, scales: Sequence[float],
                     nbs: Sequence[int], level_rows: Sequence[int],
                     n_feat: int):
    """K2: the backward of interp_fwd. feats [L, N, 64F] are the rows the
    forward read; rows [L, N] int32 place their gradient in the flat
    [sum R_l, 64F] table gradient. Returns (d_table f32, d_x [N, 3] f32)
    as fused_encode_bwd does."""
    if not x.is_cuda:
        return interp_bwd_fused_plain(x, g, feats, rows, scales, nbs,
                                      level_rows, n_feat)
    _check_bwd_inputs("interp_bwd_fused", x, g, rows, feats,
                      (len(level_rows), x.shape[0],
                       CORNERS_PER_BRICK * n_feat), len(level_rows),
                      n_feat)
    return _launch_bwd("brick_interp_bwd_fused", "interp_bwd_fused", x, g,
                       rows, feats, scales, nbs, level_rows, n_feat)


def interp_bwd(x, g, feats, scales: Sequence[float], nbs: Sequence[int],
               n_feat: int, upd_dtype=torch.float32):
    """K7: the backward of interp_fwd as update rows. x [N, 3] f32, g
    [N, L*F] bf16 cotangent, feats [L, N, 64F] bf16 rows the forward read
    -> (upd [L, N, 64F] in upd_dtype (float32 or bfloat16), every lane
    written, zero outside each sample's 8 corners; d_x [N, 3] f32, summed
    over levels, scaled and edge-gated). Scatter upd[l] at the level's rows
    to get its table gradient."""
    if not x.is_cuda:
        return interp_bwd_plain(x, g, feats, scales, nbs, n_feat, upd_dtype)
    if upd_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("interp_bwd: upd_dtype must be bfloat16 or float32")
    n, L = x.shape[0], len(scales)
    _check_bwd_inputs("interp_bwd", x, g, None, feats,
                      (L, n, CORNERS_PER_BRICK * n_feat), L, n_feat)
    upd = torch.empty((L, n, CORNERS_PER_BRICK * n_feat), dtype=upd_dtype,
                      device=x.device)
    d_x = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    if n == 0:
        return upd, d_x
    lib = _BWD.get()
    sc, nb, _ = _level_arrays(scales, nbs)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.brick_interp_bwd(x.data_ptr(), g.data_ptr(), feats.data_ptr(), L,
                              n, n_feat, sc, nb, upd.data_ptr(),
                              int(upd_dtype == torch.bfloat16), d_x.data_ptr(),
                              stream)
    _BWD.check(rc, "interp_bwd")
    launches["interp_bwd"] += 1
    return upd, d_x
