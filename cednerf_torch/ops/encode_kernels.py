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
    levels in one launch here).
  * `fused_encode_bwd_cell` (K6c) — K6 for the cell row layouts: the levels
    the caller names accumulate their table gradient per (brick row, cell)
    into [rows*27, 8F] f32, the buffer that the JAX package's cell levels
    scatter into (cednerf_tpu/ops/brick_grid.py `_make_level_encode_cell`,
    `_scatter_rows`, whose "pallas" route is pallas_scatter.py
    `scatter_add_rows`); the other levels keep K6's brick target. The
    caller rounds and folds the cell rows (ops/brick_grid.py).
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
index_add); given CUDA tensors it launches the kernel or raises. Nothing
falls back.

`launches` counts kernel launches per wrapper and `plain_cuda_calls` counts
plain-version calls on CUDA tensors (which only a kernel-versus-plain check
makes), so a run can show which route the main path took.
"""

import ctypes
from typing import Sequence

import numpy as np
import torch

from .cuda_build import KernelLibrary

BRICK_CELLS = 3          # cells per brick edge
BRICK_CORNERS = 4        # corners per brick edge
CORNERS_PER_BRICK = 64   # 4^3
CELLS_PER_BRICK = 27     # 3^3
CELL_CORNERS = 8
MAX_LEVELS = 16          # kMaxLevels in the CUDA sources
KERNEL_FEATURES = (1, 2, 4)

_NAMES = ("interp_fwd", "fused_encode_fwd", "fused_encode_bwd",
          "fused_encode_bwd_cell", "interp_bwd_fused", "interp_bwd")
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
        fn.argtypes = [_P, _P, _P, _P, _I32, _I64, _I32, _P, _P, _P, _P, _P,
                       _P]
        fn.restype = _I32
    lib.brick_fused_encode_bwd_cell.argtypes = [
        _P, _P, _P, _P, _I32, _I64, _I32, _P, _P, _P, _P, _P, _P, _P, _P]
    lib.brick_fused_encode_bwd_cell.restype = _I32
    lib.brick_interp_bwd.argtypes = [_P, _P, _P, _I32, _I64, _I32, _P, _P, _P,
                                     _I32, _P, _P]
    lib.brick_interp_bwd.restype = _I32


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


def _bwd_rows(vals, x, g, scale, nb, n_feat):
    """One level's backward from its rows [N, 64F] and cotangent g [N, F]:
    (update rows [N, 64F] f32 = w * g, d_x [N, 3] f32 scaled and
    edge-gated). The products are taken in the kernels' order: w = wx *
    (wy * wz), and d w / d frac_a = +-(the other two axes' weights)."""
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


def _launch_bwd(fn, name, x, g, rows, src, scales, nbs, level_rows, n_feat):
    n, L = x.shape[0], len(scales)
    d_table = torch.zeros((sum(level_rows), CORNERS_PER_BRICK * n_feat),
                          dtype=torch.float32, device=x.device)
    d_x = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    if n == 0:
        return d_table, d_x
    lib = _BWD.get()
    sc, nb, lr = _level_arrays(scales, nbs, level_rows)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, fn)(x.data_ptr(), g.data_ptr(), rows.data_ptr(),
                          src.data_ptr(), L, n, n_feat, sc, nb, lr,
                          d_table.data_ptr(), d_x.data_ptr(), stream)
    _BWD.check(rc, name)
    launches[name] += 1
    return d_table, d_x


def fused_encode_bwd(x, g, rows, table, scales: Sequence[float],
                     nbs: Sequence[int], level_rows: Sequence[int],
                     n_feat: int):
    """K6: the backward of fused_encode_fwd. x [N, 3] f32, g [N, L*F]
    cotangent, rows [L, N] int32, table [sum R_l, 64F] -> (d_table
    [sum R_l, 64F] f32, d_x [N, 3] f32, summed over levels, scaled and
    edge-gated). On CUDA, g and table must be bfloat16 (the forward's
    dtypes); the table gradient is summed with f32 atomics."""
    if not x.is_cuda:
        return fused_encode_bwd_plain(x, g, rows, table, scales, nbs,
                                      level_rows, n_feat)
    _check_bwd_inputs("fused_encode_bwd", x, g, rows, table,
                      (sum(level_rows), CORNERS_PER_BRICK * n_feat),
                      len(level_rows), n_feat)
    return _launch_bwd("brick_fused_encode_bwd", "fused_encode_bwd", x, g,
                       rows, table, scales, nbs, level_rows, n_feat)


def fused_encode_bwd_cell(x, g, rows, table, scales: Sequence[float],
                          nbs: Sequence[int], level_rows: Sequence[int],
                          n_feat: int, cell_rows: Sequence[int],
                          bf16_terms: bool = True):
    """K6c: fused_encode_bwd with a per-cell target. cell_rows [L]: level
    l's first row in the cell gradient, or -1 to keep the brick target.
    The cell levels' update terms w * g are formed in bf16 as the JAX cell
    levels form them at a bf16 compute dtype (cell_updates); on CUDA
    bf16_terms must be True (the kernel reads bf16 rows, so the compute
    dtype is bf16).
    Returns (d_table [sum R_l, 64F] f32, zero on the cell levels' rows;
    d_cell [sum 27 R_l over the cell levels, 8F] f32, row cell_rows[l] +
    r*27 + cell, lane (dx*4 + dy*2 + dz)*F + f; d_x [N, 3] f32)."""
    if not x.is_cuda:
        return fused_encode_bwd_cell_plain(x, g, rows, table, scales, nbs,
                                           level_rows, n_feat, cell_rows,
                                           bf16_terms)
    if not bf16_terms:
        raise ValueError("fused_encode_bwd_cell: the kernel forms bf16 terms")
    L = len(level_rows)
    _check_bwd_inputs("fused_encode_bwd_cell", x, g, rows, table,
                      (sum(level_rows), CORNERS_PER_BRICK * n_feat), L,
                      n_feat)
    if len(cell_rows) != L:
        raise ValueError("fused_encode_bwd_cell: one cell row offset a level")
    n = x.shape[0]
    n_cell = sum(27 * r for r, c in zip(level_rows, cell_rows) if c >= 0)
    d_table = torch.zeros((sum(level_rows), CORNERS_PER_BRICK * n_feat),
                          dtype=torch.float32, device=x.device)
    d_cell = torch.zeros((n_cell, CELL_CORNERS * n_feat), dtype=torch.float32,
                         device=x.device)
    d_x = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    if n == 0:
        return d_table, d_cell, d_x
    lib = _BWD.get()
    sc, nb, lr = _level_arrays(scales, nbs, level_rows)
    cr = (ctypes.c_longlong * L)(*[int(c) for c in cell_rows])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.brick_fused_encode_bwd_cell(
        x.data_ptr(), g.data_ptr(), rows.data_ptr(), table.data_ptr(), L, n,
        n_feat, sc, nb, lr, cr, d_table.data_ptr(), d_cell.data_ptr(),
        d_x.data_ptr(), stream)
    _BWD.check(rc, "fused_encode_bwd_cell")
    launches["fused_encode_bwd_cell"] += 1
    return d_table, d_cell, d_x


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
