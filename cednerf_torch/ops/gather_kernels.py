"""Row gather kernel K8 and its plain version.

  * `row_gather` (K8) — out[i] = table[idx[i]]: table [R, W] (bf16 or f32),
    idx [N] int32 -> [N, W]. Replaces cednerf_tpu/ops/pallas_gather.py
    `_gather_kernel` / `dma_gather`, the per-row DMA gather that the JAX
    package kept as a probe of the row-access rate (tools/profile_dma_gather.py).
    No model path runs it; this package's tools/profile_row_gather.py does.

An index outside [0, R) gives a row of zeros on both versions (the TPU
kernel leaves it undefined, jnp.take fills NaN). The kernel copies the bytes,
so it equals the plain version bit for bit.

The kernel lives in csrc/row_gather.cu, built by nvcc for sm_90a at first use
(ops/cuda_build.py). `rows_in_flight` (1, 2, 4, 8 or 16) takes the place of
the TPU kernel's `depth`: the rows each group of lanes keeps in flight (a
warp per 512-byte row, half a warp per 256-byte row). A CPU tensor takes the
plain version, a CUDA tensor the kernel; nothing falls back. `launches` /
`plain_cuda_calls` count as in ops/encode_kernels.py.
"""

import ctypes

import torch

from .cuda_build import KernelLibrary

ROWS_IN_FLIGHT = (1, 2, 4, 8, 16)
# the fastest setting of tools/profile_row_gather.py's sweep on an H100 over
# W = 128 and 256 bf16 together (PERF.md: every setting within 3%)
DEFAULT_ROWS_IN_FLIGHT = 8

launches = {"row_gather": 0}
plain_cuda_calls = {"row_gather": 0}


def reset_counts():
    for d in (launches, plain_cuda_calls):
        for k in d:
            d[k] = 0


def _bind(lib):
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.row_gather.argtypes = [p, p, ctypes.c_longlong, i32, i32, i32, i32, p,
                               p]
    lib.row_gather.restype = i32


_LIB = KernelLibrary("row_gather", _bind)


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain K8: table.index_select(0, idx) with the rows of indices
    outside [0, R) zeroed."""
    if idx.is_cuda:
        plain_cuda_calls["row_gather"] += 1
    if table.shape[0] == 0:
        return table.new_zeros((idx.shape[0], table.shape[1]))
    ok = (idx >= 0) & (idx < table.shape[0])
    out = table.index_select(0, torch.where(ok, idx, 0).long())
    return out.masked_fill_(~ok[:, None], 0)


def row_gather(table: torch.Tensor, idx: torch.Tensor,
               rows_in_flight: int = DEFAULT_ROWS_IN_FLIGHT) -> torch.Tensor:
    """K8: table [R, W], idx [N] int32 -> [N, W] with out[i] = table[idx[i]]
    and zeros where idx[i] is outside [0, R).

    On CUDA, table must be contiguous bfloat16 or float32 and idx contiguous
    int32; any N and W."""
    if not table.is_cuda:
        return row_gather_plain(table, idx)
    if (table.dtype not in (torch.bfloat16, torch.float32)
            or table.dim() != 2 or not table.is_contiguous()):
        raise ValueError("row_gather: table must be contiguous bfloat16 or "
                         "float32 [R, W]")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("row_gather: idx must be contiguous int32 [N]")
    if idx.device != table.device:
        raise ValueError("row_gather: inputs on different devices")
    if rows_in_flight not in ROWS_IN_FLIGHT:
        raise ValueError(f"row_gather: rows_in_flight in {ROWS_IN_FLIGHT}")
    (r, w), n = table.shape, idx.shape[0]
    if r >= 2 ** 31 or w >= 2 ** 31:
        raise ValueError(f"row_gather: table {r} x {w}")
    out = torch.empty((n, w), dtype=table.dtype, device=table.device)
    if n == 0 or w == 0:
        return out
    lib = _LIB.get()
    rc = lib.row_gather(table.data_ptr(), idx.data_ptr(), n, w, r,
                        table.element_size(), rows_in_flight, out.data_ptr(),
                        torch.cuda.current_stream(table.device).cuda_stream)
    _LIB.check(rc, "row_gather")
    launches["row_gather"] += 1
    return out
