"""Table-gradient scatter kernel K3 and its plain version.

  * `scatter_add_rows` (K3) — acc[rows[i]] += upd[i]: rows [M] int32, upd
    [M, W] (f32, or bf16) -> [n_rows, W] f32. Replaces
    cednerf_tpu/ops/pallas_scatter.py `scatter_add_rows` (helper
    `accum_rows_aligned`), the VMEM-accumulator scatter that the JAX
    package's `_scatter_rows` reaches.

Who calls it: the 4D keyframe encoder's backward (ops/brick_grid.py), once
per level per train step, with both keyframe slots' update rows in one
[2N, 64F] f32 stream. On a CUDA tensor every `scatter_impl` ("xla",
"pallas", "fused", "onehot", "auto") takes K3, as every `interp_impl` takes
K5/K6 on the 3D route: the sums are the same. The 3D brick route keeps K6
(or K2), which accumulate the table gradient themselves, for every
`scatter_impl`, so a 3D field launches no K3.

The kernel lives in csrc/scatter_add_rows.cu (f32 atomics, zero lanes
skipped, rows outside [0, n_rows) dropped), built by nvcc for sm_90a at
first use (ops/cuda_build.py). The sum is f32 whatever the caller's
accumulator dtype; a bf16 accumulator is one rounding of the finished sum,
done by the caller. A CPU tensor takes the plain version, a CUDA tensor the
kernel; nothing falls back. `launches` / `plain_cuda_calls` count as in
ops/encode_kernels.py.
"""

import ctypes

import torch

from .cuda_build import KernelLibrary

launches = {"scatter_add_rows": 0}
plain_cuda_calls = {"scatter_add_rows": 0}


def reset_counts():
    for d in (launches, plain_cuda_calls):
        for k in d:
            d[k] = 0


def _bind(lib):
    p = ctypes.c_void_p
    lib.scatter_add_rows.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, p, ctypes.c_int, p]
    lib.scatter_add_rows.restype = ctypes.c_int


_LIB = KernelLibrary("scatter_add_rows", _bind)


def scatter_add_rows_plain(rows: torch.Tensor, upd: torch.Tensor,
                           n_rows: int) -> torch.Tensor:
    """Plain K3: zeros [n_rows, W] f32, index_add_ of upd at rows. Rows
    outside [0, n_rows) go to a spill row that is cut off (dropped, as
    JAX's .at[].add drops an index past the end)."""
    if rows.is_cuda:
        plain_cuda_calls["scatter_add_rows"] += 1
    r = rows.long()
    r = torch.where((r >= 0) & (r < n_rows), r, n_rows)
    acc = torch.zeros((n_rows + 1, upd.shape[1]), dtype=torch.float32,
                      device=upd.device)
    return acc.index_add_(0, r, upd.float())[:n_rows]


def scatter_add_rows(rows: torch.Tensor, upd: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """K3: rows [M] int32, upd [M, W] -> [n_rows, W] f32 with
    out[rows[i]] += upd[i]; rows outside [0, n_rows) dropped.

    On CUDA, rows must be contiguous int32 and upd contiguous f32 or bf16;
    any M, W and n_rows."""
    if not rows.is_cuda:
        return scatter_add_rows_plain(rows, upd, n_rows)
    if (rows.dtype != torch.int32 or rows.dim() != 1
            or not rows.is_contiguous()):
        raise ValueError("scatter_add_rows: rows must be contiguous int32 [M]")
    if (upd.dtype not in (torch.float32, torch.bfloat16) or upd.dim() != 2
            or upd.shape[0] != rows.shape[0] or not upd.is_contiguous()):
        raise ValueError("scatter_add_rows: upd must be contiguous float32 or "
                         f"bfloat16 [{rows.shape[0]}, W]")
    if upd.device != rows.device:
        raise ValueError("scatter_add_rows: inputs on different devices")
    m, w = upd.shape
    if not (0 < n_rows < 2 ** 31 and 0 < w < 2 ** 31):
        raise ValueError(f"scatter_add_rows: table {n_rows} x {w}")
    if m == 0:
        return torch.zeros((n_rows, w), dtype=torch.float32,
                           device=upd.device)
    out = torch.empty((n_rows, w), dtype=torch.float32, device=upd.device)
    lib = _LIB.get()
    rc = lib.scatter_add_rows(rows.data_ptr(), upd.data_ptr(), m, w, n_rows,
                              out.data_ptr(), int(upd.dtype == torch.bfloat16),
                              torch.cuda.current_stream(upd.device).cuda_stream)
    _LIB.check(rc, "scatter_add_rows")
    launches["scatter_add_rows"] += 1
    return out
