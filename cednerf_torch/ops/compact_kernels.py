"""Budget compaction kernel K4 and its plain version.

  * `compact_select_kernel` (K4) — the packed train step's cross-ray budget
    compaction: valid [R, M] bool -> (sel [budget] int32, kept [R, M] bool).
    Replaces cednerf_tpu/ops/pallas_compact.py `_build` /
    `compact_select_pallas`, which is bit-compatible with
    cednerf_tpu/engine/renderer.py `compact_select_rayfold`.
    With n_blocks > 1 the same launch compacts n_blocks contiguous ray
    blocks on their own (JAX's `compact_select(n_blocks)`, XLA ops in the
    JAX package, the layout of cfg.compact_blocks > 1); its plain version
    is `compact_select`, the port of that function, and its launches count
    under "compact_select_blocks".

The kernel lives in csrc/compact_select.cu (a hand-written single-pass
stream compaction with decoupled look-back: one launch that reads the
lattice once, ranks it tile by tile and fills the sentinel), built by nvcc
for sm_90a at first use (ops/cuda_build.py). Its plain version,
`compact_select_rayfold`, is the port of the JAX function of that name:
both return the same bits. A CPU tensor takes the plain version, a CUDA
tensor the kernel; nothing falls back. `launches` / `plain_cuda_calls`
count as in ops/encode_kernels.py.

The kernel's scratch (one status word per tile and a tile counter that
carries a per-call epoch, so nothing is reset between calls) is allocated
once per device and stream and kept in `_SCRATCH`: a call allocates only
`sel` and `kept`.
"""

import ctypes

import torch

from .cuda_build import KernelLibrary

TILE = 8192   # candidates per tile of the kernel (kTile)
_MIN_TILES = 2048   # status words of a first scratch (16.8 M candidates)

# (device index, stream) -> int64 [tiles + 1]: the status words, then the
# tile counter, whose high half is the epoch (starts at 1, no claims)
_SCRATCH = {}

launches = {"compact_select": 0, "compact_select_blocks": 0}
plain_cuda_calls = {"compact_select": 0, "compact_select_blocks": 0}


def reset_counts():
    for d in (launches, plain_cuda_calls):
        for k in d:
            d[k] = 0


def _bind(lib):
    p = ctypes.c_void_p
    lib.compact_select.argtypes = [p, ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int, p, p, p, ctypes.c_longlong,
                                   p, p]
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


def compact_select(valid: torch.Tensor, budget: int, n_blocks: int = 1):
    """Plain K4 over blocks (port of engine/renderer.py::compact_select):
    the rays in `n_blocks` contiguous blocks, each compacted to
    budget / n_blocks slots.

    valid [R, M] bool -> (sel [budget] int32, ascending per block, R*M in
    unused slots; kept [R, M] bool; rank [R, M] int32, each kept
    candidate's slot). One cumsum per block and a scatter of the unique
    destinations; slots past a block's budget are written into a dropped
    spare column (JAX's mode="drop"). R % n_blocks and budget % n_blocks
    must be 0, as JAX asserts."""
    r, m = valid.shape
    n = r * m
    if r % n_blocks or budget % n_blocks:
        raise ValueError(f"compact_select: {r} rays / budget {budget} do not "
                         f"split into {n_blocks} blocks")
    if valid.is_cuda:
        plain_cuda_calls["compact_select_blocks"] += 1
    nb, bb = n // n_blocks, budget // n_blocks
    flat = valid.reshape(n_blocks, nb)
    dest = torch.cumsum(flat.to(torch.int64), dim=1) - 1
    write = flat & (dest < bb)
    col = torch.where(write, dest, torch.full_like(dest, bb))
    src = torch.arange(nb, device=valid.device).expand(n_blocks, nb)
    sel_b = torch.full((n_blocks, bb + 1), nb, dtype=torch.int64,
                       device=valid.device).scatter_(1, col, src)[:, :bb]
    blk = torch.arange(n_blocks, device=valid.device)[:, None]
    sel = torch.where(sel_b < nb, sel_b + blk * nb, torch.full_like(sel_b, n))
    rank = dest + blk * bb
    return (sel.reshape(-1).to(torch.int32), write.reshape(r, m),
            rank.reshape(r, m).to(torch.int32))


def compact_select_kernel(valid: torch.Tensor, budget: int,
                          n_blocks: int = 1):
    """K4: valid [R, M] bool -> (sel [budget] int32, kept [R, M] bool), the
    bits of compact_select_rayfold (one block) or of compact_select's sel
    and kept (n_blocks > 1, R and budget divisible by it). On CUDA any
    R*M < 2^31 and any budget."""
    if valid.dtype != torch.bool or valid.dim() != 2:
        raise ValueError("compact_select_kernel: valid must be bool [R, M]")
    r, m = valid.shape
    if r % n_blocks or budget % n_blocks:
        raise ValueError(f"compact_select_kernel: {r} rays / budget {budget} "
                         f"do not split into {n_blocks} blocks")
    if not valid.is_cuda:
        if n_blocks == 1:
            return compact_select_rayfold(valid, budget)
        return compact_select(valid, budget, n_blocks)[:2]
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = _scratch(dev, stream, n_blocks * -(-(n // n_blocks) // TILE))
    lib = _LIB.get()
    rc = lib.compact_select(v.data_ptr(), n, budget, n_blocks,
                            sel.data_ptr(), kept.data_ptr(),
                            status.data_ptr(), status.numel() - 1,
                            status.data_ptr() + 8 * (status.numel() - 1),
                            stream)
    _LIB.check(rc, "compact_select")
    launches["compact_select" if n_blocks == 1
             else "compact_select_blocks"] += 1
    return sel, kept


def _scratch(dev, stream: int, n_tiles: int) -> torch.Tensor:
    """The kernel's status words and tile counter for (device, stream),
    made once (zeros, the counter at epoch 1) and again only for a lattice
    of more tiles than it holds."""
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() - 1 < n_tiles:
        buf = torch.zeros(max(n_tiles, _MIN_TILES) + 1, dtype=torch.int64,
                          device=dev)
        buf[-1:].fill_(1 << 32)     # a fill: an item assignment would sync
        _SCRATCH[key] = buf
    return buf
