// Budget compaction for the packed train step on Hopper (sm_90a), bound
// through ctypes by cednerf_torch/ops/compact_kernels.py, which also holds
// its plain PyTorch version.
//
// What it replaces:
//   K4 compact_select  <- cednerf_tpu/ops/pallas_compact.py::_build (public
//                         compact_select_pallas), itself bit-compatible with
//                         engine/renderer.py::compact_select_rayfold.
//
// valid [n] bool (the [R, M] candidate lattice, flat ray-major) and a budget
// B -> sel [B] i32: the flat indices of the first min(#valid, B) valid
// candidates in ascending order, the rest of the slots set to the sentinel
// n; kept [n] bool: valid & (rank < B), rank being the number of valid
// candidates before it. This is a stream compaction with a cut-off.
//
// With n_blocks > 1 (the ray-parallel layout of
// cednerf_tpu/engine/renderer.py::compact_select, compact_blocks > 1) the
// lattice is n_blocks contiguous blocks of nb = n / n_blocks candidates
// (whole rays), each compacted on its own into its bb = B / n_blocks slots
// of sel: block b's slots [b*bb, (b+1)*bb) hold its candidates' flat
// indices (ascending), then the sentinel n; rank counts within the block.
// Each block has its own tiles, status words and look-back, so the grid's
// claims run over (block, tile) pairs, block-major; a block's fill blocks
// wait on that block's last tile only. Block starts need not be 16-byte
// aligned (nb is any multiple of M): a thread whose 32 candidates do not
// start on a 16-byte boundary loads and stores them one byte at a time.
//
// The TPU kernel walks the lattice in tiles on one core, carrying the
// running count in scratch memory, and builds each tile's ranks and
// placement with triangular, permutation and shift matmuls on the MXU, which
// holds indices as f32 (hence its n < 2^24 and budget <= 2^21 limits and its
// lane-major [B/T + 2, T] output grid). Blocks on this card run in no order,
// so the running count becomes a single-pass scan with decoupled look-back,
// one launch:
//   1. each block claims the next index from a tile counter in device
//      memory, so tiles go out in the order blocks start and a block only
//      ever waits on tiles that running blocks hold (no deadlock);
//   2. a tile block reads its 8,192 candidates once (32 per thread, two
//      16-byte loads), counts them, and publishes the count as its tile's
//      status word (one 64-bit word: a tag and a 32-bit value);
//   3. its first warp looks back over the predecessors' words, 32 at a
//      time, summing counts until it meets an inclusive prefix, and
//      publishes its own inclusive prefix;
//   4. every thread ranks its candidates (block scan of the thread counts
//      plus the tile's exclusive prefix), writes kept, and writes sel[rank]
//      for ranks below B; a tile whose prefix is already >= B writes kept
//      = 0 and no sel;
//   5. the blocks that claim indices past the last tile fill sel from the
//      grand total (the last tile's inclusive prefix, waited for) up to B
//      with the sentinel, 4,096 slots each.
// The tag of a status word is 2 * epoch + (1 for an inclusive prefix, 0
// for a count). The epoch sits in the high half of the 64-bit tile counter
// word: every block reads it with its claim, and the block that makes the
// grid's last claim resets the counter and advances the epoch (1 .. 2^31 -
// 1, then 1 again) for the next call, so a word left by an earlier call is
// never taken for this one's and the status words need no reset. Scratch
// (the status words and the counter word) is allocated once by the wrapper
// and must not be shared by two streams at once. Indices are 32-bit: any n
// < 2^31 and any budget.
//
// What bounds it on this card: memory, n + n + 4B bytes (the lattice read
// once, kept written once, sel once): 33.8 MB at the top ray bucket (16,000
// x 1,024, budget 262,144), ~10 us at 3.35 TB/s, so each launch's own
// latency counts: hence one. It takes ~0.026 ms there (an H100 80GB HBM3
// at 700 W); the rest is taken to be look-back latency (not measured: no
// profiler of the SMs on that machine).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kVecs = 2;                     // 16-byte loads per thread
constexpr int kItems = 16 * kVecs;           // candidates per thread
constexpr int kTile = kThreads * kItems;     // candidates per tile
constexpr int kFillPerThread = 16;
constexpr int kFill = kThreads * kFillPerThread;  // sel slots per fill block
constexpr unsigned kMaxEpoch = 0x7fffffffu;

typedef unsigned long long u64;

__device__ __forceinline__ u64 status_word(unsigned tag, unsigned value) {
  return ((u64)tag << 32) | value;
}

__device__ __forceinline__ void store_status(u64* p, u64 w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ u64 load_status(const u64* p) {
  u64 w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Exclusive prefix of v over the block's threads; *total receives the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_warp[lane] : 0;
    const int wi = warp_inclusive_scan(w);
    if (lane < kWarps) s_warp[lane] = wi - w;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  return s_warp[warp] + incl - v;
}

struct alignas(16) Items {
  uint8_t v[kItems];
};

// This thread's 32 candidates (0 at `end` and past it). `valid` is 16-byte
// aligned (the wrapper checks), so a whole chunk at an aligned `base` is
// two vector loads; an unaligned one (a block start off 16 bytes) is read
// byte by byte.
__device__ __forceinline__ Items load_items(const uint8_t* __restrict__ valid,
                                            long long base, long long end) {
  Items it;
  if (base + kItems <= end && (base & 15) == 0) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      reinterpret_cast<uint4*>(it.v)[j] =
          __ldcs(reinterpret_cast<const uint4*>(valid + base) + j);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      it.v[k] = base + k < end ? valid[base + k] : 0;
  }
  return it;
}

__device__ __forceinline__ int count_items(const Items& it) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems / 4; ++j)
    c += __popc(__vcmpne4(reinterpret_cast<const uint32_t*>(it.v)[j], 0u)) >> 3;
  return c;
}

// Whether a status word holds this call's count or prefix (tag_count or
// tag_count | 1).
__device__ __forceinline__ bool published(u64 w, unsigned tag_count) {
  return ((unsigned)(w >> 32) | 1u) == (tag_count | 1u);
}

// The exclusive prefix of tile `tile` (> 0), from the predecessors' status
// words, by the block's first warp; every lane returns it.
__device__ __forceinline__ unsigned look_back(const u64* status, int tile,
                                              unsigned tag_count,
                                              unsigned tag_prefix) {
  const int lane = threadIdx.x;
  unsigned excl = 0;
  for (int last = tile - 1;; last -= 32) {
    const int j = last - lane;
    // before tile 0 counts as an inclusive prefix of 0
    u64 w = j >= 0 ? load_status(status + j) : status_word(tag_prefix, 0);
    while (__any_sync(kFull, !published(w, tag_count))) {
      if (!published(w, tag_count)) w = load_status(status + j);
    }
    const unsigned prefixes =
        __ballot_sync(kFull, (unsigned)(w >> 32) == tag_prefix);
    // the nearest inclusive prefix ends the walk: sum the counts after it
    // and the prefix itself
    const int stop = prefixes ? __ffs(prefixes) - 1 : 32;
    excl += __reduce_add_sync(kFull, lane <= stop ? (unsigned)w : 0u);
    if (prefixes) return excl;
  }
}

// Grid: n_blocks * n_tiles tile claims (n_tiles per block, block-major),
// then n_blocks * n_fill fill claims. budget and nb are per block.
__global__ void __launch_bounds__(kThreads)
    compact_select_kernel(const uint8_t* __restrict__ valid, long long n,
                          long long nb, int n_tiles, int n_fill, int budget,
                          int* __restrict__ sel, uint8_t* __restrict__ kept,
                          u64* status, u64* counter) {
  __shared__ int s_warp[32];
  __shared__ int s_total;
  __shared__ int s_tile;
  __shared__ unsigned s_epoch;
  __shared__ int s_prefix;
  if (threadIdx.x == 0) {
    const u64 claim = atomicAdd(counter, 1ull);
    const unsigned tile = (unsigned)claim;
    const unsigned epoch = (unsigned)(claim >> 32);
    if (tile == gridDim.x - 1) {
      // the grid's last claim: reset the counter and advance the epoch
      const unsigned next = epoch >= kMaxEpoch ? 1u : epoch + 1u;
      atomicExch(counter, (u64)next << 32);
    }
    s_tile = (int)tile;
    s_epoch = epoch;
  }
  __syncthreads();
  const unsigned tag_count = s_epoch << 1, tag_prefix = tag_count | 1u;
  const int n_blocks = (int)(n / nb);

  if (s_tile >= n_blocks * n_tiles) {
    // fill: sentinel from the block's grand total up to its budget
    const int f = s_tile - n_blocks * n_tiles;
    const int blk = f / n_fill;
    const long long first = (long long)(f % n_fill) * kFill;
    if (threadIdx.x == 0) {
      const u64* last = status + ((long long)blk * n_tiles + n_tiles - 1);
      u64 w;
      while ((unsigned)((w = load_status(last)) >> 32) != tag_prefix)
        __nanosleep(64);
      s_total = (int)(unsigned)w;
    }
    __syncthreads();
    const long long total = s_total;
    int* sel_b = sel + (long long)blk * budget;
#pragma unroll
    for (int k = 0; k < kFillPerThread; ++k) {
      const long long j = first + k * kThreads + threadIdx.x;
      if (j < budget && j >= total) sel_b[j] = (int)n;
    }
    return;
  }

  const int blk = s_tile / n_tiles, tile = s_tile % n_tiles;
  status += (long long)blk * n_tiles;       // this block's status words
  sel += (long long)blk * budget;
  const long long start = (long long)blk * nb, end = start + nb;
  const long long base =
      start + (long long)tile * kTile + (long long)threadIdx.x * kItems;
  const Items it = load_items(valid, base, end);
  const int c = count_items(it);
  const int thread_excl = block_exclusive_scan(c, s_warp, &s_total);
  const unsigned agg = (unsigned)s_total;
  if (threadIdx.x < 32) {
    unsigned excl = 0;
    if (tile == 0) {
      if (threadIdx.x == 0) store_status(status, status_word(tag_prefix, agg));
    } else {
      if (threadIdx.x == 0)
        store_status(status + tile, status_word(tag_count, agg));
      excl = look_back(status, tile, tag_count, tag_prefix);
      if (threadIdx.x == 0)
        store_status(status + tile, status_word(tag_prefix, excl + agg));
    }
    if (threadIdx.x == 0) s_prefix = (int)excl;
  }
  __syncthreads();
  const int prefix = s_prefix;
  Items out;
  int rank = prefix + thread_excl;
  if (rank >= budget) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      reinterpret_cast<uint4*>(out.v)[j] = make_uint4(0, 0, 0, 0);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool on = it.v[k] != 0;
      const bool keep = on && rank < budget;
      out.v[k] = keep ? 1 : 0;
      if (keep) sel[rank] = (int)(base + k);
      rank += on;
    }
  }
  if (base + kItems <= end && (base & 15) == 0) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      __stcs(reinterpret_cast<uint4*>(kept + base) + j,
             reinterpret_cast<const uint4*>(out.v)[j]);
  } else {
    for (int k = 0; k < kItems; ++k)
      if (base + k < end) kept[base + k] = out.v[k];
  }
}

}  // namespace

extern "C" {

const char* cednerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Scratch from the wrapper, kept across calls: status [status_len] u64
// (one word per tile of every block, at least n_blocks * ceil(n /
// n_blocks / 8192)), counter [1] u64 (starts at 1 << 32: epoch 1, no
// claims). n and budget split into n_blocks equal blocks. Returns
// cudaGetLastError() after the launch (0 on success).
int compact_select(const uint8_t* valid, long long n, int budget,
                   int n_blocks, int* sel, uint8_t* kept,
                   unsigned long long* status, long long status_len,
                   unsigned long long* counter, void* stream) {
  if (n <= 0 || n >= (1LL << 31) || budget <= 0 || n_blocks <= 0 ||
      n % n_blocks || budget % n_blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = n / n_blocks;
  const long long bb = budget / n_blocks;
  const long long n_tiles = (nb + kTile - 1) / kTile;
  const long long n_fill = (bb + kFill - 1) / kFill;
  const long long grid = n_blocks * (n_tiles + n_fill);
  if (n_blocks * n_tiles > status_len || grid >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  compact_select_kernel<<<(unsigned)grid, kThreads, 0, st>>>(
      valid, n, nb, (int)n_tiles, (int)n_fill, (int)bb, sel, kept, status,
      counter);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
