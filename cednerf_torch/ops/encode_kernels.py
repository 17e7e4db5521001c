"""Brick-encoder forward kernels K1 and K5, and their plain versions.

  * `interp_fwd` (K1) — trilinear interpolation of pre-gathered brick rows,
    all levels in one launch. Replaces cednerf_tpu/ops/pallas_encoder.py
    `_build_fwd` / `interp_fwd`.
  * `fused_encode_fwd` (K5) — the same with the row gather inside the kernel.
    Replaces cednerf_tpu/ops/pallas_fused.py `_build_fused_fwd` /
    `fused_encode_fwd`. It is the CUDA route of `brick_encode`.

Both kernels live in csrc/brick_encode_fwd.cu. nvcc builds it for sm_90a the
first time a kernel is called (or `build()` is), into cednerf_torch/_build/,
and the library is bound through ctypes. A wrapper given CPU tensors runs
the plain version, the same function written in plain PyTorch (gather,
compare-built lane weights, multiply, sum); given CUDA tensors it launches
the kernel or raises. Nothing falls back.

`launches` counts kernel launches per wrapper and `plain_cuda_calls` counts
plain-version calls on CUDA tensors (which only a kernel-versus-plain check
makes), so a run can show which route the main path took.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Sequence

import numpy as np
import torch

BRICK_CELLS = 3          # cells per brick edge
BRICK_CORNERS = 4        # corners per brick edge
CORNERS_PER_BRICK = 64   # 4^3
MAX_LEVELS = 16          # kMaxLevels in the CUDA source
KERNEL_FEATURES = (1, 2, 4)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "brick_encode_fwd.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = {"interp_fwd": 0, "fused_encode_fwd": 0}
plain_cuda_calls = {"interp_fwd": 0, "fused_encode_fwd": 0}


def reset_counts():
    for d in (launches, plain_cuda_calls):
        for k in d:
            d[k] = 0


# --------------------------------------------------------------------- #
# Build and binding


class _KernelLibrary:
    """The nvcc-built shared library, compiled and loaded on first use."""

    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()
        self.build_seconds = None
        self.build_log = ""

    def get(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._load(self._build())
            return self._lib

    def _build(self) -> str:
        with open(SOURCE, "rb") as fh:
            src = fh.read()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = os.path.join(BUILD_DIR, f"libbrick_encode_fwd_{tag[:16]}.so")
        if os.path.exists(so):
            self.build_seconds = 0.0
            return so
        nvcc = shutil.which("nvcc") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found (looked for {nvcc})")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                f"{self.build_log}")
        os.replace(tmp, so)
        return so

    @staticmethod
    def _load(path: str):
        lib = ctypes.CDLL(path)
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.brick_fused_encode_fwd.argtypes = [p, p, p, i32, i64, i32, p, p,
                                               p, p, i32, p]
        lib.brick_fused_encode_fwd.restype = i32
        lib.brick_interp_fwd.argtypes = [p, p, i32, i64, i32, p, p, p, i32, p]
        lib.brick_interp_fwd.restype = i32
        lib.brick_error_string.argtypes = [i32]
        lib.brick_error_string.restype = ctypes.c_char_p
        return lib


_LIBRARY = _KernelLibrary()


def build():
    """Build (if needed) and load the kernels; returns (seconds, nvcc log)."""
    _LIBRARY.get()
    return _LIBRARY.build_seconds, _LIBRARY.build_log


def _check(lib, rc: int, name: str):
    if rc != 0:
        raise RuntimeError(
            f"{name}: CUDA error {rc} ({lib.brick_error_string(rc).decode()})")


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
    lib = _LIBRARY.get()
    sc, nb, _ = _level_arrays(scales, nbs)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.brick_interp_fwd(x.data_ptr(), feats.data_ptr(), L, n, n_feat,
                              sc, nb, out.data_ptr(),
                              int(out_dtype == torch.float32), stream)
    _check(lib, rc, "interp_fwd")
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
    lib = _LIBRARY.get()
    sc, nb, lr = _level_arrays(scales, nbs, level_rows)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.brick_fused_encode_fwd(rows.data_ptr(), x.data_ptr(),
                                    table.data_ptr(), L, n, n_feat, sc, nb,
                                    lr, out.data_ptr(),
                                    int(out_dtype == torch.float32), stream)
    _check(lib, rc, "fused_encode_fwd")
    launches["fused_encode_fwd"] += 1
    return out
