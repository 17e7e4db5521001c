"""Table-gradient scatter kernel K3 and its plain version.

  * `scatter_add_rows` (K3) — acc[rows[i]] += upd[i]: rows [M] int32, upd
    [M, W] (f32, or bf16) -> [n_rows, W] f32, a new zeroed buffer or one
    the caller passes (`out`, added into). Replaces
    cednerf_tpu/ops/pallas_scatter.py `scatter_add_rows` (helper
    `accum_rows_aligned`), the VMEM-accumulator scatter that the JAX
    package's `_scatter_rows` reaches.
  * `key_sort` — the stable sort in front of every ordered reduce (K3's
    and ops/encode_kernels.py's table_reduce): int32 keys over the bits a
    key count needs, an int32 index (csrc/key_sort.cuh, built into both
    libraries). It replaces no TPU kernel (see there); it replaces
    torch.sort, which no CUDA path calls.

Who calls K3: the 4D keyframe encoder's backward (ops/brick_grid.py), once
per level per train step: a brick level's corner entries, one F-wide row a
(keyframe slot, sample, corner) at key keyframe row * 64 + corner, into
[rows*K*64, F] (the [rows*K, 64F] table gradient); a cell level's [2N, 8F]
rows into the resident cell buffer, `out`. On a CUDA tensor every
`scatter_impl` ("xla", "pallas", "fused", "onehot", "auto") takes K3, as
every `interp_impl` takes K5/K6 on the 3D route: the sums are the same.
The 3D brick route keeps K6 (or K2), which accumulate the table gradient
themselves, for every `scatter_impl`, so a 3D field launches no K3.

The kernel lives in csrc/scatter_add_rows.cu, built by nvcc for sm_90a at
first use (ops/cuda_build.py). It sums in a fixed order, so that a
backward gives the same bits on every run as the TPU's does: the row
indices sorted stably (key_sort), each output row's update rows added
in sorted order (ascending i) by the reduce kernel, the partial rows of a
row whose run crosses a tile edge in tile order by the carry folded into
it (csrc/ordered_reduce.cuh: whoever arrives last at the run's counter in
`carry_counts`); rows outside [0, n_rows) dropped; no float atomics.
Rows of at most NARROW_WIDTH lanes (the model paths' rows) are summed in
tiles of NARROW_TILE sorted entries, wider ones in tiles of REDUCE_TILE.
The tri-plane encoder's backward (ops/triplane.py) sends its texel
gradient through it too. The sum is f32 whatever the caller's accumulator
dtype; a bf16 accumulator is one rounding of the finished sum, done by
the caller. A CPU tensor takes the plain version, a CUDA tensor the
kernel; nothing falls back. `launches` / `plain_cuda_calls` count as in
ops/encode_kernels.py (`key_sort` each sort, K3's and table_reduce's).
"""

import ctypes

import torch

from .cuda_build import KernelLibrary

launches = {"scatter_add_rows": 0, "key_sort": 0}
plain_cuda_calls = {"scatter_add_rows": 0, "key_sort": 0}
REDUCE_TILE = 256   # sorted entries a reduce tile, here and in
                    # ops/encode_kernels.py's table_reduce
NARROW_WIDTH = 16   # K3's rows up to this width: the narrow kernel
NARROW_TILE = 1024  # and its tiles (kNarrow, csrc/scatter_add_rows.cu)
SORT_BLOCK_KEYS = 2048   # keys a sort block (kBlockKeys, csrc/key_sort.cuh)
SORT_CLUSTER_BLOCKS = 8  # blocks a cluster, which ranks a tile (kCluster)
SORT_TILE_KEYS = SORT_CLUSTER_BLOCKS * SORT_BLOCK_KEYS   # kTileKeys
SORT_DIGIT_BITS = 9      # the widest digit a pass sorts (kMaxDigitBits)


def reset_counts():
    for d in (launches, plain_cuda_calls):
        for k in d:
            d[k] = 0


def _bind(lib):
    p = ctypes.c_void_p
    i32, i64 = ctypes.c_int, ctypes.c_longlong
    lib.scatter_add_rows.argtypes = [p, p, p, i64, i32, i32, p, i32, i32,
                                     i32, p, p, p]
    lib.scatter_add_rows.restype = i32
    lib.scatter_carry_counts.argtypes = [i64, i32, i32]
    lib.scatter_carry_counts.restype = i64
    bind_key_sort(lib)


def bind_key_sort(lib):
    """The ctypes signatures of key_sort, which both libraries export."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.key_sort.argtypes = [p, i64, i32, p, p, p, p]
    lib.key_sort.restype = i32
    lib.key_sort_scratch_words.argtypes = [i64, i32]
    lib.key_sort_scratch_words.restype = i64


_LIB = KernelLibrary("scatter_add_rows", _bind)

# The ordered reduces' arrival counters (csrc/ordered_reduce.cuh
# fold_carry), one int32 buffer per (device, stream), all zero between
# calls: the last arriver at a crossing run's counter puts it back to 0,
# so no call fills it. A call that needs more counters than the buffer
# holds replaces it by a larger zeroed one; make it (a call at the largest
# size) before a CUDA graph capture. Calls on one stream run one after
# another, which keeps the zeros between them.
_CARRY_COUNTS = {}


def carry_counts(device, n: int) -> torch.Tensor:
    """The resident arrival counters of (device, its current stream): int32,
    at least n of them (a power of two), all zero."""
    dev = torch.device(device)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    buf = _CARRY_COUNTS.get(key)
    if buf is None or buf.numel() < n:
        size = 1 << max(int(n) - 1, 0).bit_length()
        buf = _CARRY_COUNTS[key] = torch.zeros(size, dtype=torch.int32,
                                               device=dev)
    return buf


def sort_plan(n_keys: int):
    """(bits, passes, digit bits) of key_sort over keys in [0, n_keys]: the
    bit length of n_keys, ceil(bits / SORT_DIGIT_BITS) passes of
    ceil(bits / passes) bits each (the last pass over what is left)."""
    bits = min(int(n_keys).bit_length(), 31)
    passes = -(-bits // SORT_DIGIT_BITS)
    return bits, passes, -(-bits // passes)


def key_sort_plain(keys: torch.Tensor, n_keys: int):
    """Plain key_sort, pass by pass as csrc/key_sort.cuh runs it: keys [M]
    int32 -> (sorted keys [M] int32, perm [M] int32). A key outside
    [0, n_keys) takes the drop value n_keys. First the histogram: every
    pass's digit totals from one read of the keys, and from them each
    digit's first position. Then each pass over tiles of SORT_TILE_KEYS
    consecutive keys (a cluster's): each tile's digit counts; their
    exclusive scan over the tiles, digit by digit (the look-back: a
    digit's keys in the earlier tiles); a key's rank among its tile's keys
    of its digit (the kernel's blocks of the cluster and their warps rank
    it; here a stable argsort within the tile); the key and its index
    written to first position + earlier tiles' count + rank. The result
    is the stable sort's permutation, torch.sort(stable=True)'s."""
    if keys.is_cuda:
        plain_cuda_calls["key_sort"] += 1
    k = keys.reshape(-1).long()
    k = torch.where((k >= 0) & (k < n_keys), k, n_keys)
    m = k.numel()
    v = torch.arange(m, device=k.device)
    _, passes, dbits = sort_plan(n_keys)
    bins = 1 << dbits
    first = []                                          # the histogram
    for p in range(passes):
        total = torch.bincount((k >> (p * dbits)) & (bins - 1),
                               minlength=bins)
        first.append(torch.cumsum(total, 0) - total)
    tiles = -(-m // SORT_TILE_KEYS)
    tile = torch.arange(m, device=k.device) // SORT_TILE_KEYS
    slot = torch.arange(m, device=k.device)
    for p in range(passes):
        digit = (k >> (p * dbits)) & (bins - 1)
        group = tile * bins + digit                     # tile-major
        count = torch.bincount(group, minlength=tiles * bins)
        earlier = (count.view(tiles, bins).cumsum(0)
                   - count.view(tiles, bins)).view(-1)  # the look-back
        order = torch.argsort(group, stable=True)       # rank in a tile
        rank = torch.empty_like(k)
        rank[order] = slot - (torch.cumsum(count, 0) - count)[group[order]]
        pos = first[p][digit] + earlier[group] + rank
        k = torch.empty_like(k).index_put_((pos,), k)
        v = torch.empty_like(v).index_put_((pos,), v)
    return k.to(torch.int32), v.to(torch.int32)


def key_sort(keys: torch.Tensor, n_keys: int, lib=None):
    """The stable sort of int32 keys [M] in front of an ordered reduce:
    (sorted keys [M] int32, perm [M] int32, the input index of each
    entry); a key outside [0, n_keys) takes the drop value n_keys and sorts
    last. On CUDA the kernel of csrc/key_sort.cuh (`lib`: the
    KernelLibrary to launch it from, K3's by default; both export it),
    on the CPU its plain version."""
    if not keys.is_cuda:
        return key_sort_plain(keys, n_keys)
    if (keys.dtype != torch.int32 or keys.dim() != 1
            or not keys.is_contiguous()):
        raise ValueError("key_sort: keys must be contiguous int32 [M]")
    m = keys.numel()
    if m >= 2 ** 31 - 1 or not 0 < n_keys < 2 ** 31:
        raise ValueError(f"key_sort: {m} keys, n_keys {n_keys}")
    lib = lib or _LIB
    cdll = lib.get()
    # both outputs 16-byte aligned: the narrow reduce loads them as int4
    out = torch.empty((2, -(-m // 4) * 4), dtype=torch.int32,
                      device=keys.device)[:, :m]
    if m == 0:
        return out[0], out[1]
    scratch = torch.empty((cdll.key_sort_scratch_words(m, n_keys),),
                          dtype=torch.int32, device=keys.device)
    rc = cdll.key_sort(keys.data_ptr(), m, n_keys, out[0].data_ptr(),
                       out[1].data_ptr(), scratch.data_ptr(),
                       torch.cuda.current_stream(keys.device).cuda_stream)
    lib.check(rc, "key_sort")
    launches["key_sort"] += 1
    return out[0], out[1]


def ordered_reduce_plain(keys: torch.Tensor, upd: torch.Tensor,
                         n_rows: int, out=None) -> torch.Tensor:
    """The plain ordered reduce: out[keys[i]] += upd[i] with each row's
    terms summed in stable sorted order of the keys, which is ascending
    i. Keys outside [0, n_rows) go to a spill row that is cut off (dropped,
    as JAX's .at[].add drops an index past the end). out None: a new
    zeroed [n_rows, W] f32; else the caller's, added into and returned.

    The sorted keys go to index_add_, which on the CPU adds in index order,
    so each row is summed in sorted order, equal bit for bit to index_add_
    of the unsorted keys; on CUDA index_add_ adds with atomics, so there
    this is only the kernels' check at a tolerance."""
    k = keys.reshape(-1).long()
    order = torch.argsort(k, stable=True)
    k = k[order]
    k = torch.where((k >= 0) & (k < n_rows), k, n_rows)
    acc = torch.zeros((n_rows + 1, upd.shape[1]), dtype=torch.float32,
                      device=upd.device)
    acc.index_add_(0, k, upd.float()[order])
    if out is None:
        return acc[:n_rows]
    return out.add_(acc[:n_rows])


def scatter_add_rows_plain(rows: torch.Tensor, upd: torch.Tensor,
                           n_rows: int, out=None) -> torch.Tensor:
    """Plain K3: ordered_reduce_plain of upd at rows."""
    if rows.is_cuda:
        plain_cuda_calls["scatter_add_rows"] += 1
    return ordered_reduce_plain(rows, upd, n_rows, out)


def carry_plain(keys: torch.Tensor, part: torch.Tensor, tile: int,
                n_keys: int):
    """Plain carry (csrc/ordered_reduce.cuh fold_carry, folded into the
    reduce kernels) over the reduce's partial rows part [2, tiles, W]
    (heads, then tails) of the sorted keys [E]: (the keys in [0, n_keys)
    whose run crosses a tile edge, [K] int64; their sums [K, W] f32), each
    the tail partial of the run's first tile plus the head partials of the
    later tiles it covers, added in tile order (ordered_reduce_plain: on
    the CPU the kernel's order and bits)."""
    k = keys.reshape(-1).long()
    tiles = part.shape[1]
    s = torch.arange(tiles, device=k.device) * tile
    end = torch.clamp(s + tile, max=k.numel())
    first, last = k[s], k[end - 1]
    ok = (first >= 0) & (first < n_keys)
    head = torch.zeros_like(ok)
    head[1:] = (first[1:] == k[s[1:] - 1]) & ok[1:]
    goes_on = torch.zeros_like(ok)
    goes_on[:-1] = (k[end[:-1]] == last[:-1]) & (last[:-1] >= 0) \
        & (last[:-1] < n_keys)
    tail = goes_on & ~(head & (first == last))   # the run begins here
    t_idx, h_idx = tail.nonzero()[:, 0], head.nonzero()[:, 0]
    order = torch.argsort(torch.cat([t_idx, h_idx]), stable=True)
    rows = torch.cat([part[1, t_idx], part[0, h_idx]])[order]
    rkeys = torch.cat([last[t_idx], first[h_idx]])[order]
    chained = torch.unique(rkeys)
    return chained, ordered_reduce_plain(rkeys, rows, n_keys)[chained]


def scatter_add_rows(rows: torch.Tensor, upd: torch.Tensor,
                     n_rows: int, out=None) -> torch.Tensor:
    """K3: rows [M] int32, upd [M, W] -> [n_rows, W] f32 with
    out[rows[i]] += upd[i]; rows outside [0, n_rows) dropped. `out` None:
    a new buffer, zeroed first; else the caller's [n_rows, W] f32 buffer,
    added into and returned.

    On CUDA, rows must be contiguous int32, upd contiguous f32 or bf16 and
    out contiguous f32; any M, W and n_rows. Each output row is its update
    rows summed in ascending i (in two levels where a row's run crosses a
    tile of REDUCE_TILE sorted rows, NARROW_TILE at W <= NARROW_WIDTH),
    then added into `out`: the same bits on every run."""
    return _scatter_add_rows(rows, upd, n_rows, out)


def reduce_tile(w: int) -> int:
    """K3's tile of sorted entries for rows of w lanes."""
    return NARROW_TILE if w <= NARROW_WIDTH else REDUCE_TILE


def _scatter_add_rows(rows, upd, n_rows: int, out=None, part=None,
                      tile=None):
    """scatter_add_rows; `tile` (reduce_tile(W) by default) changes only
    where the kernel's sums split in two levels (a CPU tensor takes the
    plain version's strict order); `part`, a [2, ceil(M / tile), W] f32
    buffer, keeps the reduce's partial rows (the tests hold the folded
    carry to carry_plain of them)."""
    if out is not None and (out.dtype != torch.float32
                            or tuple(out.shape) != (n_rows, upd.shape[1])
                            or not out.is_contiguous()
                            or out.device != upd.device):
        raise ValueError("scatter_add_rows: out must be contiguous float32 "
                         f"[{n_rows}, {upd.shape[1]}] on {upd.device}")
    if not rows.is_cuda:
        return scatter_add_rows_plain(rows, upd, n_rows, out)
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
        return out if out is not None else torch.zeros(
            (n_rows, w), dtype=torch.float32, device=upd.device)
    add = out is not None
    if not add:
        out = torch.empty((n_rows, w), dtype=torch.float32, device=upd.device)
    tile = reduce_tile(w) if tile is None else tile
    if tile < 1:
        raise ValueError(f"scatter_add_rows: tile {tile}")
    keys, perm = key_sort(rows, n_rows)
    shape = (2, -(-m // tile), w)
    if part is None:
        part = torch.empty(shape, dtype=torch.float32, device=upd.device)
    elif (tuple(part.shape) != shape or part.dtype != torch.float32
          or not part.is_contiguous() or part.device != upd.device):
        raise ValueError(f"scatter_add_rows: part must be contiguous "
                         f"float32 {shape} on {upd.device}")
    lib = _LIB.get()
    count = carry_counts(upd.device, lib.scatter_carry_counts(m, w, tile))
    stream = torch.cuda.current_stream(upd.device).cuda_stream
    rc = lib.scatter_add_rows(keys.data_ptr(), perm.data_ptr(),
                              upd.data_ptr(), m, w, n_rows, out.data_ptr(),
                              int(upd.dtype == torch.bfloat16), int(add),
                              tile, part.data_ptr(), count.data_ptr(), stream)
    if rc:
        count.zero_()
    _LIB.check(rc, "scatter_add_rows")
    launches["scatter_add_rows"] += 1
    return out
