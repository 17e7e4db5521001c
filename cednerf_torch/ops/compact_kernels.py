"""Budget compaction kernel K4 and its plain version.

  * `compact_select_kernel` (K4) — the packed train step's cross-ray budget
    compaction: valid [R, M] bool -> (sel [budget] int32, kept [R, M] bool).
    Replaces cednerf_tpu/ops/pallas_compact.py `_build` /
    `compact_select_pallas`, which is bit-compatible with
    cednerf_tpu/engine/renderer.py `compact_select_rayfold`.

The kernel lives in csrc/compact_select.cu (a hand-written multi-pass
stream compaction: tile counts, one scan of the tile totals, a ranking and
select pass, a sentinel fill), built by nvcc for sm_90a at first use
(ops/cuda_build.py). Its plain version, `compact_select_rayfold`, is the
port of the JAX function of that name: both return the same bits. A CPU
tensor takes the plain version, a CUDA tensor the kernel; nothing falls
back. `launches` / `plain_cuda_calls` count as in ops/encode_kernels.py.
"""

import ctypes

import torch

from .cuda_build import KernelLibrary

TILE = 4096   # candidates per block of the count and select passes

launches = {"compact_select": 0}
plain_cuda_calls = {"compact_select": 0}


def reset_counts():
    for d in (launches, plain_cuda_calls):
        for k in d:
            d[k] = 0


def _bind(lib):
    p = ctypes.c_void_p
    lib.compact_select.argtypes = [p, ctypes.c_longlong, ctypes.c_int, p, p,
                                   p, p, p]
    lib.compact_select.restype = ctypes.c_int


_LIB = KernelLibrary("compact_select", _bind)


def compact_select_rayfold(valid: torch.Tensor, budget: int):
    """Plain K4 (port of engine/renderer.py::compact_select_rayfold).

    valid [R, M] bool -> (sel [budget] int32: flat indices of the first
    min(#valid, budget) valid candidates in ray-major order, ascending, the
    remaining slots R*M; kept [R, M] bool: valid and within the budget).
    The owning-ray build adds at ray starts clamped to the budget into a
    buffer of budget + 1 slots whose last slot is dropped (JAX's
    .at[].add(mode="drop")), and the lane gather is clamped into the
    lattice where JAX reads past it for slots that `used` then masks."""
    if valid.is_cuda:
        plain_cuda_calls["compact_select"] += 1
    r, m = valid.shape
    n = r * m
    dev = valid.device
    inc = torch.cumsum(valid.to(torch.int64), dim=-1)             # [R, M]
    counts_all = inc[:, -1]
    ray_start = torch.cumsum(counts_all, 0) - counts_all          # [R]
    rank = ray_start[:, None] + inc - 1
    kept = valid & (rank < budget)
    order = torch.argsort(torch.logical_not(valid).to(torch.uint8), dim=-1,
                          stable=True)
    starts_c = torch.clamp(ray_start, max=budget)
    hits = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    hits.index_add_(0, starts_c, torch.ones_like(starts_c))
    ray_id = torch.cumsum(hits[:budget], 0) - 1                    # [B]
    slot = torch.arange(budget, dtype=torch.int64, device=dev)
    slot_start = starts_c[ray_id]
    lane = order.reshape(-1)[torch.clamp(ray_id * m + (slot - slot_start),
                                         0, n - 1)]
    total = torch.clamp(counts_all.sum(), max=budget)
    sel = torch.where(slot < total, ray_id * m + lane,
                      torch.full_like(slot, n))
    return sel.to(torch.int32), kept


def compact_select_kernel(valid: torch.Tensor, budget: int):
    """K4: valid [R, M] bool -> (sel [budget] int32, kept [R, M] bool), the
    bits of compact_select_rayfold. On CUDA any R*M < 2^31 and any budget."""
    if not valid.is_cuda:
        return compact_select_rayfold(valid, budget)
    if valid.dtype != torch.bool or valid.dim() != 2:
        raise ValueError("compact_select_kernel: valid must be bool [R, M]")
    r, m = valid.shape
    n = r * m
    if not 0 < n < 2 ** 31 or budget < 1:
        raise ValueError(f"compact_select_kernel: lattice {r}x{m}, budget "
                         f"{budget} outside 0 < R*M < 2^31, budget >= 1")
    v = valid.contiguous()
    if v.data_ptr() % 16:
        v = v.clone()
    dev = v.device
    sel = torch.empty(budget, dtype=torch.int32, device=dev)
    kept = torch.empty((r, m), dtype=torch.bool, device=dev)
    offsets = torch.empty(-(-n // TILE), dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _LIB.get()
    rc = lib.compact_select(v.data_ptr(), n, budget, sel.data_ptr(),
                            kept.data_ptr(), offsets.data_ptr(),
                            total.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    _LIB.check(rc, "compact_select")
    launches["compact_select"] += 1
    return sel, kept
