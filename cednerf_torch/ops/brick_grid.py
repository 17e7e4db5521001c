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
before it is cast to the table's dtype. 4D keyframe levels and the
cell/cellz layouts arrive with later slices and raise NotImplementedError.
"""

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from . import encode_kernels as ek
from .encode_kernels import BRICK_CELLS, CORNERS_PER_BRICK
from .hash_grid import _PRIMES, level_resolution, level_scale

_U32 = 0xFFFFFFFF


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
    """Kernel output [sum R_l, 64F] f32 -> one gradient per level table."""
    if geom.accum_bf16:
        d_flat = d_flat.to(torch.bfloat16)
    return tuple(d.to(dt) for d, dt in
                 zip(d_flat.split(list(geom.level_rows)), dtypes))


@dataclasses.dataclass(frozen=True)
class _Geom:
    scales: Tuple[float, ...]
    nbs: Tuple[int, ...]
    level_rows: Tuple[int, ...]
    n_feat: int
    compute_dtype: torch.dtype
    accum_bf16: bool


class _BrickEncode(torch.autograd.Function):
    """Two kernel routes. `interp=False`: forward K5 (fused_encode_fwd) on
    the flat table, backward K6 (fused_encode_bwd) re-gathering from it.
    `interp=True`: forward K1 (interp_fwd) on [L, N, 64F] rows gathered
    here, backward K2 (interp_bwd_fused) on the same saved rows."""

    @staticmethod
    def forward(ctx, x, rows, geom, interp, *tables):
        if interp:
            src = torch.empty((len(tables), x.shape[0], tables[0].shape[1]),
                              dtype=geom.compute_dtype, device=x.device)
            for lvl, table in enumerate(tables):
                torch.index_select(table.to(geom.compute_dtype), 0,
                                   rows[lvl].long(), out=src[lvl])
            out = ek.interp_fwd(x, src, geom.scales, geom.nbs, geom.n_feat,
                                out_dtype=geom.compute_dtype)
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
        x, rows, src = ctx.saved_tensors
        geom = ctx.geom
        g = g.to(src.dtype).contiguous()
        if ctx.interp:
            d_flat, d_x = ek.interp_bwd_fused(
                x, g, src, rows, geom.scales, geom.nbs, geom.level_rows,
                geom.n_feat)
        else:
            d_flat, d_x = ek.fused_encode_bwd(
                x, g, rows, src, geom.scales, geom.nbs, geom.level_rows,
                geom.n_feat)
        return (d_x, None, None, None,
                *_table_grads(d_flat, geom, ctx.dtypes))


def brick_encode(x: torch.Tensor, params: Dict[str, torch.Tensor],
                 spec: BrickGridSpec, t: Optional[torch.Tensor] = None,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Multiresolution brick-grid encoding, differentiable in x and in every
    table of `params`.

    x: [N, 3] unit-cube positions; params from BrickGridSpec.init_params.
    Returns [N, n_levels * n_features] in compute_dtype. The tables are cast
    to compute_dtype before the gather, as in the JAX encoder; the lane math
    and the sums run in f32. On CUDA the compute dtype must be bfloat16 (the
    kernels read bf16 rows)."""
    if spec.time_keyframes:
        raise NotImplementedError(
            "brick_encode: 4D keyframe levels (grid_type='hash4d') come with "
            "a later slice of the port")
    if spec.row_layout != "brick":
        raise NotImplementedError(
            f"brick_encode: row_layout={spec.row_layout!r} comes with a later "
            "slice of the port; this slice has the 'brick' layout")
    if spec.grad_accum_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"brick_encode: grad_accum_dtype "
                         f"{spec.grad_accum_dtype!r} is not float32/bfloat16")
    if x.is_cuda:
        if spec.interp_impl == "plain":
            raise ValueError("brick_encode: the plain version was requested "
                             "on a CUDA tensor; the CUDA route is the kernel")
        if compute_dtype != torch.bfloat16:
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
                 accum_bf16=spec.grad_accum_dtype == "bfloat16")
    with torch.no_grad():
        rows = torch.stack([
            _level_geom(x, scales[lvl], geom.nbs[lvl], lay["hashed"],
                        lay["rows"])[0]
            for lvl, lay in enumerate(layouts)])                 # [L, N]
    return _BrickEncode.apply(x, rows, geom, spec.interp_impl == "interp",
                              *level_tables(params, spec))
