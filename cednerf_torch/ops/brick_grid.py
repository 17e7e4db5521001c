"""Brick-layout multiresolution hash grid (port of
cednerf_tpu/ops/brick_grid.py).

Storage layout and semantics are the JAX package's, so parameters carry over
through bridge.py unchanged:

  * each table row holds a 4x4x4 brick of corner features (64 corners x F,
    lane = corner*F + f, corner = dx*16 + dy*4 + dz); a brick covers 3x3x3
    cells, so one row gather serves a (sample, level);
  * DENSE levels (bricks <= the row cap) keep the canonical corner grid
    `grid_{l}` [n, n, n, F] and materialize overlapping bricks per call;
  * HASHED levels keep `bricks_{l}` [rows, 64F] and hash the brick
    coordinate with the xor primes in uint32 arithmetic.

The port has the 3D brick row layout, forward and backward, as one
torch.autograd.Function per route (ops/encode_kernels.py holds the kernels):

  * the default: forward K5 (in-kernel row gather), backward K6, which
    re-gathers the rows from the saved flat bf16 table;
  * `interp_impl == "interp"`: forward K1 on rows gathered by torch,
    backward K2 on those saved rows (JAX's non-remat residuals);
  * on the CPU, the plain versions of the same kernels.

The kernels return the gradient of the flat [sum R_l, 64F] table; dense
levels get their `grid_{l}` gradient from autograd through
`_materialize_dense_bricks` (overlapping brick corners sum), as JAX gets
it from XLA autodiff. The table gradient is summed in f32 whatever
`grad_accum_dtype` says; "bfloat16" rounds the finished sum to bf16 once
before it is cast to the table's dtype.

4D keyframe levels (`time_keyframes` K > 0, grid_type "hash4d"; port of
`_make_level_encode_4d`): each level's table is viewed as [(rows*K), 64F]
with row r*K + k holding keyframe k of brick row r, and the features are
lerp(row[lo], row[lo + 1], t_frac) inside the spatial interpolation. One
torch.autograd.Function per level. Its forward is plain PyTorch on the 8
corners of the sample's cell (the JAX forward is XLA code, no Pallas
kernel), in f32 on values gathered in the compute dtype. Its backward
builds the keyframe-split terms (w * g * (1 - t_frac) for keyframe lo,
w * g * t_frac for lo + 1) of the cell's 8 corners, one F-wide entry a
(slot, sample, corner) keyed keyframe row * 64 + corner ([2N*8, F] f32,
not the [2N, 64F] update rows with their 56 zero corners), and sends them
through K3 (ops/scatter_kernels.py) on CUDA, for every `scatter_impl`, or
its plain index_add on the CPU; plus the edge-gated d_x and
d_t = sum(w * (hi - lo) * g) * (K - 1) when t needs a gradient.

Row layouts `cell`, `cellz` and `cellfused` (JAX `row_layout`). JAX
expands a level's bf16-cast brick table into one row per (brick, cell)
([rows*27, 8F]; cellz packs the 3 cells of a z-column into one 24F row,
the same buffer reshaped) and runs the level on those rows. Which levels
take it follows JAX's rule (`cell_levels`): 3D hashed levels with rows*27
<= cell_rows_cap (rows*9 for cellz), and every 4D level with rows*K*27 <=
cap (cellz and cellfused mean cell there). The expansion is a 0/1
selection, so the forward is the brick forward (K5 on CUDA). The backward
is where the layouts differ from brick: the per-cell f32 sums are rounded
to the compute dtype, folded onto the brick corners (the expansion
matmul's transpose, a sum over the cells that share a corner) with the
result in the compute dtype, and only then cast to the f32 master, where
the brick route keeps its f32 sum. The port keeps those rounding points:
on the 3D route K6c (`fused_encode_bwd_cell`) accumulates the cell rows,
on the 4D route K3 scatters the keyframe-split cell update rows, each into
a buffer that stays resident and all zero between calls
(`encode_kernels.cell_buffer`), and `fold_cells` (a kernel on CUDA, one
launch for every cell level of the 3D route) rounds and folds them into
the cell levels' rows of the table gradient, zeroing what it read.

`remat_feats`: the K1/K2 route keeps (x, rows, tables) in place of the
gathered rows [L, N, 64F] and gathers them again in the backward with the
same index_select; the 4D levels gather their corner values again. The
K5/K6 route saves no per-sample rows in the first place (K6 re-gathers
from the flat table), so the flag changes nothing there.
"""

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import encode_kernels as ek
from . import scatter_kernels as sk
from .encode_kernels import (BRICK_CELLS, CELL_CORNERS, CELLS_PER_BRICK,
                             CORNERS_PER_BRICK)
from .hash_grid import _PRIMES, level_resolution, level_scale

_U32 = 0xFFFFFFFF
ROW_LAYOUTS = ("brick", "cell", "cellz", "cellfused")
ZROWS_PER_BRICK = BRICK_CELLS * BRICK_CELLS   # cellz rows of a brick


@dataclasses.dataclass(frozen=True)
class BrickGridSpec:
    """Static config for the brick-layout grid (fields as in the JAX spec).

    interp_impl in the port: "interp" takes K1 forward and K2 backward
    (torch row gather + the interpolation kernels), "plain" asks for the
    plain versions (CPU only), and every other value ("xla", the JAX
    default, "pallas", "dma") takes K5 forward and K6 backward, the port's
    CUDA default."""

    n_levels: int = 16
    n_features: int = 2
    base_res: int = 16
    max_res: int = 4096
    log2_hashmap_size: int = 19
    time_keyframes: int = 0
    max_table_rows: int = 16384
    fine_table_rows: int = 0
    fine_from_level: int = 5
    grad_accum_dtype: str = "float32"
    scatter_impl: str = "xla"
    interp_impl: str = "xla"
    remat_feats: bool = False
    row_layout: str = "brick"
    cell_rows_cap: int = 524288

    @property
    def log_b(self) -> float:
        if self.n_levels == 1:
            return 0.0
        return math.log(self.max_res / self.base_res) / (self.n_levels - 1)

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def row_width(self) -> int:
        """Values per brick row (per keyframe slice)."""
        return CORNERS_PER_BRICK * self.n_features

    @property
    def keyframes(self) -> int:
        return max(self.time_keyframes, 1)

    def level_scales(self) -> List[float]:
        return [level_scale(lvl, self.log_b, self.base_res)
                for lvl in range(self.n_levels)]

    def level_layout(self) -> List[dict]:
        """Per-level static layout descriptors."""
        base_rows = max(2 ** self.log2_hashmap_size // 16, 1)
        out = []
        for lvl in range(self.n_levels):
            if self.fine_table_rows and lvl >= self.fine_from_level:
                hashed_rows = self.fine_table_rows
            else:
                hashed_rows = min(base_rows, self.max_table_rows)
            res = level_resolution(level_scale(lvl, self.log_b, self.base_res))
            # corner lattice spans [0, res]; bricks of 3 cells cover it
            n_bricks_axis = max((res + BRICK_CELLS - 1) // BRICK_CELLS, 1)
            dense_rows = n_bricks_axis ** 3
            hashed = dense_rows > hashed_rows
            out.append({
                "res": res,
                "n_bricks_axis": n_bricks_axis,
                "rows": hashed_rows if hashed else dense_rows,
                "hashed": hashed,
            })
        return out

    def param_shapes(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """Parameter tensors per level: dense corner grids or brick tables."""
        shapes = []
        k = self.keyframes
        for lvl, lay in enumerate(self.level_layout()):
            if lay["hashed"]:
                shapes.append((f"bricks_{lvl}", (lay["rows"],
                                                 k * self.row_width)))
            else:
                n = lay["n_bricks_axis"] * BRICK_CELLS + 1
                shapes.append((f"grid_{lvl}", (n, n, n, k * self.n_features)))
        return shapes

    def cell_levels(self) -> List[bool]:
        """Per level: does it take the cell route? (the JAX dispatch,
        cednerf_tpu/ops/brick_grid.py brick_encode)"""
        lays = self.level_layout()
        if self.row_layout == "brick":
            return [False] * len(lays)
        if self.time_keyframes:
            return [lay["rows"] * self.keyframes * CELLS_PER_BRICK
                    <= self.cell_rows_cap for lay in lays]
        per = ZROWS_PER_BRICK if self.row_layout == "cellz" \
            else CELLS_PER_BRICK
        return [lay["hashed"] and lay["rows"] * per <= self.cell_rows_cap
                for lay in lays]

    def init_params(self, generator: torch.Generator,
                    device="cpu") -> Dict[str, torch.Tensor]:
        """Uniform(-1e-4, 1e-4) tables, drawn from `generator` in level
        order (the JAX spec's distribution, not its random stream)."""
        params = {}
        for name, shape in self.param_shapes():
            t = torch.empty(shape, dtype=torch.float32, device=device)
            params[name] = t.uniform_(-1e-4, 1e-4, generator=generator)
        return params


def _expand_brick_axis(g: torch.Tensor, axis: int, nb: int) -> torch.Tensor:
    """Split one corner axis [3*nb+1] into brick x corner axes [nb, 4]:
    bricks[..., b, d, ...] = g[..., 3*b + d, ...]."""
    pre, post = g.shape[:axis], g.shape[axis + 1:]
    main = g.narrow(axis, 0, 3 * nb).reshape(pre + (nb, 3) + post)
    idx = torch.arange(3, 3 * nb + 1, 3, device=g.device)
    far = g.index_select(axis, idx).reshape(pre + (nb, 1) + post)
    return torch.cat([main, far], dim=axis + 1)


def _materialize_dense_bricks(grid: torch.Tensor,
                              n_bricks_axis: int) -> torch.Tensor:
    """Overlapping 4^3 windows of the canonical corner grid, stride 3.

    grid: [N, N, N, F] with N = 3*n_bricks_axis + 1.
    Returns [n_bricks_axis^3, 64 * F] in corner-major row layout."""
    nb = n_bricks_axis
    f = grid.shape[-1]
    g = _expand_brick_axis(grid, 0, nb)   # [nb,4,X,X,F]
    g = _expand_brick_axis(g, 2, nb)      # [nb,4,nb,4,X,F]
    g = _expand_brick_axis(g, 4, nb)      # [nb,4,nb,4,nb,4,F]
    g = g.permute(0, 2, 4, 1, 3, 5, 6)    # [nb,nb,nb,4,4,4,F]
    return g.reshape(nb ** 3, CORNERS_PER_BRICK * f)


def _level_geom(x: torch.Tensor, scale: float, nb: int, hashed: bool,
                n_rows: int):
    """Rows + intra-brick cell + fraction for one level.

    Returns (rows [N] i32, intra [N,3] i32, frac [N,3] f32, ok [N,3] f32 --
    1 where the cell was not edge-clamped). Hashed rows reproduce the JAX
    uint32 arithmetic (multiply by the primes with wrap-around, xor, modulo)
    in int64 masked to 32 bits, so they equal the JAX rows exactly."""
    cell_raw, cell, intra, frac = ek.cell_geom(x, scale, nb)
    hi = nb * BRICK_CELLS - 1
    ok = ((cell_raw >= 0) & (cell_raw <= hi)).float()
    brick = cell // BRICK_CELLS
    if hashed:
        h = ((brick[:, 0] * _PRIMES[0]) & _U32) \
            ^ ((brick[:, 1] * _PRIMES[1]) & _U32) \
            ^ ((brick[:, 2] * _PRIMES[2]) & _U32)
        rows = h % n_rows
    else:
        rows = (brick[:, 0] * nb + brick[:, 1]) * nb + brick[:, 2]
    return rows.to(torch.int32), intra.to(torch.int32), frac, ok


def level_tables(params: Dict[str, torch.Tensor], spec: BrickGridSpec):
    """Per-level [rows, 64F] brick tables (dense levels materialized)."""
    tables = []
    for lvl, lay in enumerate(spec.level_layout()):
        if lay["hashed"]:
            tables.append(params[f"bricks_{lvl}"])
        else:
            tables.append(_materialize_dense_bricks(params[f"grid_{lvl}"],
                                                    lay["n_bricks_axis"]))
    return tables


def _flat_table(tables, dtype) -> torch.Tensor:
    """The level tables concatenated in order, cast to `dtype`."""
    flat = torch.empty((sum(t.shape[0] for t in tables), tables[0].shape[1]),
                       dtype=dtype, device=tables[0].device)
    off = 0
    for table in tables:
        flat[off:off + table.shape[0]].copy_(table)
        off += table.shape[0]
    return flat


def _table_grads(d_flat, geom, dtypes):
    """Kernel output d_flat [sum R_l, 64F] f32 -> one gradient per level
    table, cast to its table's dtype: a brick level's f32 sums rounded to
    bf16 under a bf16 accumulator (one cast of the whole table, the
    fewest launches), a cell level's folded rows (already in the compute
    dtype) as they are."""
    rounded = d_flat.to(torch.bfloat16) if geom.accum_bf16 else d_flat
    split = list(geom.level_rows)
    return tuple((d if cell else r).to(dt) for d, r, dt, cell in zip(
        d_flat.split(split), rounded.split(split), dtypes, geom.cells))


@dataclasses.dataclass(frozen=True)
class _Geom:
    scales: Tuple[float, ...]
    nbs: Tuple[int, ...]
    level_rows: Tuple[int, ...]
    n_feat: int
    compute_dtype: torch.dtype
    accum_bf16: bool
    cells: Tuple[bool, ...]       # the levels on the cell route
    remat: bool                   # remat_feats (the K1/K2 route)


def _gather_rows(x, rows, tables, dtype) -> torch.Tensor:
    """[L, N, 64F] brick rows of every level in `dtype` (K1's input)."""
    src = torch.empty((len(tables), x.shape[0], tables[0].shape[1]),
                      dtype=dtype, device=x.device)
    for lvl, table in enumerate(tables):
        torch.index_select(table.to(dtype), 0, rows[lvl].long(),
                           out=src[lvl])
    return src


class _BrickEncode(torch.autograd.Function):
    """Two kernel routes. `interp=False`: forward K5 (fused_encode_fwd) on
    the flat table, backward K6 (fused_encode_bwd) re-gathering from it, or
    K6c (fused_encode_bwd_cell) when some level takes the cell route.
    `interp=True`: forward K1 (interp_fwd) on [L, N, 64F] rows gathered
    here, backward K2 (interp_bwd_fused) on the same rows: saved, or
    gathered again under remat_feats."""

    @staticmethod
    def forward(ctx, x, rows, geom, interp, *tables):
        if interp:
            src = _gather_rows(x, rows, tables, geom.compute_dtype)
            out = ek.interp_fwd(x, src, geom.scales, geom.nbs, geom.n_feat,
                                out_dtype=geom.compute_dtype)
            if geom.remat:
                ctx.save_for_backward(x, rows, *tables)
            else:
                ctx.save_for_backward(x, rows, src)
        else:
            src = _flat_table(tables, geom.compute_dtype)
            out = ek.fused_encode_fwd(x, src, rows, geom.scales, geom.nbs,
                                      geom.level_rows, geom.n_feat,
                                      out_dtype=geom.compute_dtype)
            ctx.save_for_backward(x, rows, src)
        ctx.geom, ctx.interp = geom, interp
        ctx.dtypes = [t.dtype for t in tables]
        return out

    @staticmethod
    def backward(ctx, g):
        x, rows, *saved = ctx.saved_tensors
        geom = ctx.geom
        g = g.to(geom.compute_dtype).contiguous()
        if ctx.interp:
            src = (_gather_rows(x, rows, saved, geom.compute_dtype)
                   if geom.remat else saved[0])
            d_flat, d_x = ek.interp_bwd_fused(
                x, g, src, rows, geom.scales, geom.nbs, geom.level_rows,
                geom.n_feat)
        elif any(geom.cells):
            cell_rows, off = [], 0
            for n_rows, cell in zip(geom.level_rows, geom.cells):
                cell_rows.append(off if cell else -1)
                off += CELLS_PER_BRICK * n_rows if cell else 0
            d_flat, d_x = ek.fused_encode_bwd_cell(
                x, g, rows, saved[0], geom.scales, geom.nbs,
                geom.level_rows, geom.n_feat, cell_rows, geom.compute_dtype,
                geom.accum_bf16)
        else:
            d_flat, d_x = ek.fused_encode_bwd(
                x, g, rows, saved[0], geom.scales, geom.nbs,
                geom.level_rows, geom.n_feat)
        return (d_x, None, None, None,
                *_table_grads(d_flat, geom, ctx.dtypes))


def keyframe_tables(params: Dict[str, torch.Tensor],
                    spec: BrickGridSpec) -> List[torch.Tensor]:
    """Per-level [(rows*K), 64F] keyframe views of a 4D spec's tables: row
    r*K + k is keyframe k of brick row r. Hashed levels store `bricks_{l}`
    [rows, K*64F] keyframe-major (a view); dense levels materialize
    `grid_{l}` [n, n, n, K*F] into corner-major [nb^3, 64, K, F] bricks
    and move the keyframe axis ahead of the corners, as JAX does."""
    k, f = spec.keyframes, spec.n_features
    tables = []
    for lvl, lay in enumerate(spec.level_layout()):
        if lay["hashed"]:
            table = params[f"bricks_{lvl}"]
        else:
            table = _materialize_dense_bricks(params[f"grid_{lvl}"],
                                              lay["n_bricks_axis"])
            table = table.reshape(-1, CORNERS_PER_BRICK, k, f).permute(
                0, 2, 1, 3)
        tables.append(table.reshape(-1, spec.row_width))
    return tables


def _time_geom(t: torch.Tensor, keyframes: int):
    """(idx_lo [N] int64, t_frac [N] f32), as the JAX encoder computes
    them: t_scaled = t * (K - 1) rounded to f32, idx_lo = clip(floor, 0,
    K - 2), t_frac = t_scaled - idx_lo (XLA does not contract these under
    jit: the rounded t_scaled also feeds the floor). At t = 1, idx_lo =
    K - 2 and t_frac = 1."""
    ts = t.reshape(-1).float() * float(keyframes - 1)
    lo = torch.floor(ts).clamp(0, keyframes - 2)
    return lo.to(torch.int64), ts - lo


@dataclasses.dataclass(frozen=True)
class _KeyLevel:
    scale: float
    nb: int
    hashed: bool
    n_rows: int
    n_feat: int
    keyframes: int
    compute_dtype: torch.dtype
    accum_bf16: bool
    cell: bool = False            # the cell route's backward
    remat: bool = False           # remat_feats: gather lo/hi again


# a corner's F values in the compute dtype, moved as one machine word
_WORDS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _gather_corners(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [R, F] (contiguous), idx [...] int64 -> [..., F].

    Where a corner's F values fill one 2-, 4- or 8-byte word (bf16 at F = 4:
    8 bytes) the gather is a 1-D index_select of words: on CUDA, index_select
    of a 2-D tensor with 16-byte or narrower rows launches one block per
    index, which at a train step's 2 x 8 x 262,144 corners per level costs
    milliseconds where the bytes cost microseconds."""
    f = table.shape[1]
    word = _WORDS.get(f * table.element_size())
    if word is None:
        out = table.index_select(0, idx.reshape(-1))
    else:
        out = table.view(word).reshape(-1).index_select(
            0, idx.reshape(-1)).view(table.dtype)
    return out.view(*idx.shape, f)


def _corner_bits(device) -> torch.Tensor:
    """[3, 8] int64: bit a of corner j = 4*bx + 2*by + bz (bx, by, bz)."""
    j = torch.arange(8, device=device)
    return torch.stack([(j >> 2) & 1, (j >> 1) & 1, j & 1])


def _keyframe_feats(lohi, t_frac, dtype):
    """lerp of the two keyframes' corner values lohi [2, N, 8, F] in f32,
    with t_frac and 1 - t_frac rounded to the compute dtype as JAX rounds
    them."""
    tfc = t_frac.to(dtype).float()[:, None, None]
    one_m = (1.0 - tfc).to(dtype).float()
    return lohi[0].float() * one_m + lohi[1].float() * tfc


class _KeyframeLevelEncode(torch.autograd.Function):
    """One 4D level: (flat [(rows*K), 64F], x [N, 3], t [N, 1]) -> [N, F],
    given the time geometry (idx_lo, t_frac) that every level shares.

    Forward: the cell's 8 corners (j = 4*bx + 2*by + bz) of keyframes lo and
    lo + 1, one gather of [2, N, 8, F] in the compute dtype, the lerp and the
    trilinear sum; the corner values (or, under remat_feats, the table, to
    gather them again) and the geometry are saved for the backward (under
    no_grad the node, and with it what it saved, is dropped when the
    forward returns). Backward: K3 on the keyframe-split terms (brick
    levels: [2N*8, F] corner entries keyed keyframe row * 64 + corner; on
    the cell route cell rows [2N, 8F] that are then rounded and folded as
    JAX's `_make_level_encode_cell_4d`), d_x and d_t."""

    @staticmethod
    def forward(ctx, flat, x, t, idx_lo, t_frac, lv: _KeyLevel):
        rows, intra, frac, ok = _level_geom(x, lv.scale, lv.nb, lv.hashed,
                                            lv.n_rows)
        bits = _corner_bits(x.device)                                 # [3, 8]
        corner = ((intra[:, :, None] + bits)
                  * (4 ** (2 - torch.arange(3, device=x.device)))[:, None]
                  ).sum(1)                                            # [N, 8]
        w3 = torch.where(bits == 1, frac[:, :, None],
                         1.0 - frac[:, :, None])                   # [N, 3, 8]
        w = (w3[:, 0] * w3[:, 1]) * w3[:, 2]
        lo_row = rows.long() * lv.keyframes + idx_lo
        lohi = _keyframe_corners(flat, lo_row, corner, lv)    # [2, N, 8, F]
        out = (_keyframe_feats(lohi, t_frac, lv.compute_dtype)
               * w[:, :, None]).sum(1)
        saved = flat if lv.remat else lohi
        ctx.save_for_backward(lo_row, corner, w3, w, ok, t_frac, saved)
        ctx.lv, ctx.flat_dtype, ctx.t_shape = lv, flat.dtype, t.shape
        return out.to(lv.compute_dtype)

    @staticmethod
    def backward(ctx, g_out):
        lo_row, corner, w3, w, ok, t_frac, saved = ctx.saved_tensors
        lv = ctx.lv
        lohi = (_keyframe_corners(saved, lo_row, corner, lv) if lv.remat
                else saved)
        g = g_out.float()
        n, f = g.shape
        d_flat = d_x = d_t = None
        if ctx.needs_input_grad[0]:
            upd = w[:, :, None] * g[:, None, :]                   # [N, 8, F]
            tf = t_frac[:, None, None]
            if lv.cell:
                if lv.compute_dtype == torch.bfloat16:
                    # the JAX cell level's terms w * g in bf16 (see
                    # encode_kernels.cell_updates); w3[:, :, 7] is frac
                    fa = w3[:, :, 7].to(torch.bfloat16)[:, :, None]
                    wb = torch.where(_corner_bits(g.device) == 1, fa,
                                     1.0 - fa)                     # [N, 3, 8]
                    upd = (((wb[:, 0] * wb[:, 1]) * wb[:, 2])[:, :, None]
                           * g_out.to(torch.bfloat16)[:, None, :]).float()
                c0 = corner[:, 0]
                cidx = ((c0 // 16) * BRICK_CELLS + (c0 // 4) % 4) \
                    * BRICK_CELLS + c0 % 4
                crow = lo_row * CELLS_PER_BRICK + cidx
                rows = torch.cat([crow, crow + CELLS_PER_BRICK]).to(
                    torch.int32)
                upd_rows = torch.cat([upd * (1.0 - tf), upd * tf]).view(
                    2 * n, CELL_CORNERS * f)
                # K3 adds into the resident cell buffer, which the fold
                # leaves all zero again (ek.cell_buffer)
                n_rows = lv.n_rows * lv.keyframes
                d_cell = ek.cell_buffer(g.device, [n_rows], f)
                try:
                    sk.scatter_add_rows(rows, upd_rows, d_cell.shape[0],
                                        out=d_cell)
                    del upd_rows
                    d_flat = ek.fold_cells(
                        d_cell, torch.empty(
                            (n_rows, CORNERS_PER_BRICK * f),
                            dtype=torch.float32, device=g.device),
                        [n_rows], [0], f, lv.compute_dtype, lv.accum_bf16)
                except BaseException:
                    d_cell.zero_()
                    raise
            else:
                # one F-wide entry a (keyframe slot, sample, corner) at key
                # keyframe row * 64 + corner: the table gradient [rows*K,
                # 64F] viewed as [rows*K*64, F]. Each lane gets the terms
                # the [2N, 64F] update rows would give it, in the same
                # order (slot, sample), without their 56 zero corners.
                key = lo_row[:, None] * CORNERS_PER_BRICK + corner  # [N, 8]
                rows = torch.cat([key, key + CORNERS_PER_BRICK]).reshape(
                    -1).to(torch.int32)
                n_keyrows = lv.n_rows * lv.keyframes
                d_flat = sk.scatter_add_rows(
                    rows, torch.cat([upd * (1.0 - tf), upd * tf]).view(
                        2 * n * 8, f),
                    n_keyrows * CORNERS_PER_BRICK).view(
                        n_keyrows, CORNERS_PER_BRICK * f)
                if lv.accum_bf16:
                    d_flat = d_flat.to(torch.bfloat16)
            d_flat = d_flat.to(ctx.flat_dtype)
        if ctx.needs_input_grad[1]:
            h = (_keyframe_feats(lohi, t_frac, lv.compute_dtype)
                 * g[:, None, :]).sum(-1)                           # [N, 8]
            # d w / d frac_a = +-(the other two axes' weights)
            others = torch.stack([w3[:, 1] * w3[:, 2], w3[:, 0] * w3[:, 2],
                                  w3[:, 0] * w3[:, 1]], 1)         # [N, 3, 8]
            sign = _corner_bits(g.device) * 2.0 - 1.0
            d_x = (h[:, None, :] * sign * others).sum(-1) \
                * float(np.float32(lv.scale)) * ok
        if ctx.needs_input_grad[2]:
            dlt = ((lohi[1].float() - lohi[0].float())
                   * g[:, None, :]).sum(-1)
            d_t = ((dlt * w).sum(-1) * float(lv.keyframes - 1)).reshape(
                ctx.t_shape)
        return d_flat, d_x, d_t, None, None, None


def _keyframe_corners(flat, lo_row, corner, lv: _KeyLevel) -> torch.Tensor:
    """[2, N, 8, F]: the cell's corners of keyframes lo and lo + 1 in the
    compute dtype (one gather of words, _gather_corners)."""
    base = lo_row[:, None] * CORNERS_PER_BRICK + corner
    return _gather_corners(
        flat.to(lv.compute_dtype).reshape(-1, lv.n_feat),
        torch.stack([base, base + CORNERS_PER_BRICK]))


def _encode_keyframes(x, t, params, spec: BrickGridSpec, compute_dtype):
    layouts = spec.level_layout()
    scales = spec.level_scales()
    cells = spec.cell_levels()
    tables = keyframe_tables(params, spec)
    with torch.no_grad():
        idx_lo, t_frac = _time_geom(t, spec.keyframes)
    outs = []
    for lvl, flat in enumerate(tables):
        lay = layouts[lvl]
        lv = _KeyLevel(scale=scales[lvl], nb=lay["n_bricks_axis"],
                       hashed=lay["hashed"], n_rows=lay["rows"],
                       n_feat=spec.n_features, keyframes=spec.keyframes,
                       compute_dtype=compute_dtype,
                       accum_bf16=spec.grad_accum_dtype == "bfloat16",
                       cell=cells[lvl], remat=spec.remat_feats)
        outs.append(_KeyframeLevelEncode.apply(flat, x, t, idx_lo, t_frac,
                                               lv))
    return torch.cat(outs, dim=-1)


def brick_encode(x: torch.Tensor, params: Dict[str, torch.Tensor],
                 spec: BrickGridSpec, t: Optional[torch.Tensor] = None,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Multiresolution brick-grid encoding, differentiable in x and in every
    table of `params` (and in t, for a 4D keyframe spec).

    x: [N, 3] unit-cube positions; t: [N, 1] times in [0, 1] (4D specs
    only); params from BrickGridSpec.init_params. Returns
    [N, n_levels * n_features] in compute_dtype. The tables are cast to
    compute_dtype before the gather, as in the JAX encoder; the lane math
    and the sums run in f32. On CUDA the 3D route's compute dtype must be
    bfloat16 (the kernels read bf16 rows)."""
    if spec.row_layout not in ROW_LAYOUTS:
        raise ValueError(f"brick_encode: row_layout {spec.row_layout!r} is "
                         f"not one of {ROW_LAYOUTS}")
    if spec.grad_accum_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"brick_encode: grad_accum_dtype "
                         f"{spec.grad_accum_dtype!r} is not float32/bfloat16")
    if x.is_cuda and spec.interp_impl == "plain":
        raise ValueError("brick_encode: the plain version was requested "
                         "on a CUDA tensor; the CUDA route is the kernel")
    if spec.time_keyframes:
        if t is None:
            raise ValueError("brick_encode: a 4D keyframe spec "
                             "(time_keyframes > 0) needs t [N, 1]")
        return _encode_keyframes(x.float().contiguous(), t.float(), params,
                                 spec, compute_dtype)
    if x.is_cuda and compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            "brick_encode: the CUDA kernels read bf16 rows; "
            f"compute_dtype={compute_dtype} runs only on the CPU")
    x = x.float().contiguous()
    layouts = spec.level_layout()
    scales = spec.level_scales()
    geom = _Geom(scales=tuple(scales),
                 nbs=tuple(lay["n_bricks_axis"] for lay in layouts),
                 level_rows=tuple(lay["rows"] for lay in layouts),
                 n_feat=spec.n_features, compute_dtype=compute_dtype,
                 accum_bf16=spec.grad_accum_dtype == "bfloat16",
                 cells=tuple(spec.cell_levels()), remat=spec.remat_feats)
    with torch.no_grad():
        rows = torch.stack([
            _level_geom(x, scales[lvl], geom.nbs[lvl], lay["hashed"],
                        lay["rows"])[0]
            for lvl, lay in enumerate(layouts)])                 # [L, N]
    # JAX's all-levels Pallas route (the port's K1/K2) is the brick
    # layout's only; the cell layouts run per level on XLA ops there
    interp = spec.interp_impl == "interp" and spec.row_layout == "brick"
    return _BrickEncode.apply(x, rows, geom, interp,
                              *level_tables(params, spec))
