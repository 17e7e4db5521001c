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
// The TPU kernel walks the lattice in tiles on one core, carrying the
// running count in scratch memory, and builds each tile's ranks and
// placement with triangular, permutation and shift matmuls on the MXU, which
// holds indices as f32 (hence its n < 2^24 and budget <= 2^21 limits and its
// lane-major [B/T + 2, T] output grid). Blocks on this card run in no order,
// so the running count becomes a scan over block totals:
//   1. count: each block of 256 threads counts the valid candidates of its
//      4,096-candidate tile (16 per thread, one 16-byte load);
//   2. scan: one block scans the tile counts into exclusive tile offsets
//      and the grand total (a loop over chunks of 1,024 with a carry);
//   3. select: each block re-reads its tile, ranks every candidate (thread
//      prefix + warp shuffle scan + block scan of warp totals + the tile
//      offset), writes kept, and writes sel[rank] = index for rank < B;
//   4. fill: slots from the total up to B get the sentinel n.
// Indices are 32-bit: any n < 2^31 and any budget.
//
// What bounds it on this card: memory, ~2n + 4B bytes (the lattice is read
// twice, kept written once, sel once); 16.4 MB of lattice at the top ray
// bucket (16,000 x 1,024) is ~10 us of traffic, so the four launches cost
// more than the bytes at that size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;

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
// Callers __syncthreads() before calling it again (it reuses the scratch).
template <int kT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total) {
  constexpr int kWarps = kT / 32;
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

// This thread's 16 candidates (0 past the end). `valid` is 16-byte aligned
// (the wrapper checks), so a whole chunk is one vector load.
__device__ __forceinline__ Items load_items(const uint8_t* __restrict__ valid,
                                            long long base, long long n) {
  Items it;
  if (base + kItems <= n) {
    *reinterpret_cast<uint4*>(it.v) =
        __ldg(reinterpret_cast<const uint4*>(valid + base));
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      it.v[k] = base + k < n ? valid[base + k] : 0;
  }
  return it;
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(const uint8_t* __restrict__ valid, long long n,
                 int* __restrict__ tile_counts) {
  __shared__ int s_warp[32];
  __shared__ int s_total;
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  const Items it = load_items(valid, base, n);
  int c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) c += it.v[k] != 0;
  block_exclusive_scan<kThreads>(c, s_warp, &s_total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = s_total;
}

// In place: tile counts -> exclusive tile offsets; *total = grand total.
__global__ void __launch_bounds__(kScanThreads)
    scan_tiles_kernel(int* __restrict__ offsets, int n_tiles,
                      int* __restrict__ total) {
  __shared__ int s_warp[32];
  __shared__ int s_total;
  int carry = 0;
  for (int start = 0; start < n_tiles; start += kScanThreads) {
    const int j = start + threadIdx.x;
    const int v = j < n_tiles ? offsets[j] : 0;
    const int excl = block_exclusive_scan<kScanThreads>(v, s_warp, &s_total);
    if (j < n_tiles) offsets[j] = carry + excl;
    carry += s_total;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(kThreads)
    select_kernel(const uint8_t* __restrict__ valid, long long n,
                  const int* __restrict__ tile_offsets, int budget,
                  int* __restrict__ sel, uint8_t* __restrict__ kept) {
  __shared__ int s_warp[32];
  __shared__ int s_total;
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  const Items it = load_items(valid, base, n);
  int c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) c += it.v[k] != 0;
  int rank = tile_offsets[blockIdx.x] +
             block_exclusive_scan<kThreads>(c, s_warp, &s_total);
  Items out;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool on = it.v[k] != 0;
    const bool keep = on && rank < budget;
    out.v[k] = keep ? 1 : 0;
    if (keep) sel[rank] = (int)(base + k);
    rank += on;
  }
  if (base + kItems <= n) {
    *reinterpret_cast<uint4*>(kept + base) =
        *reinterpret_cast<const uint4*>(out.v);
  } else {
    for (int k = 0; k < kItems; ++k)
      if (base + k < n) kept[base + k] = out.v[k];
  }
}

__global__ void fill_kernel(int* __restrict__ sel, int budget,
                            const int* __restrict__ total, int sentinel) {
  const int first = *total;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < budget; j += (long long)gridDim.x * blockDim.x)
    if (j >= first) sel[j] = sentinel;
}

}  // namespace

extern "C" {

const char* cednerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Scratch: tile_offsets [ceil(n / 4096)] i32, total [1] i32. Returns
// cudaGetLastError() after the launches (0 on success).
int compact_select(const uint8_t* valid, long long n, int budget, int* sel,
                   uint8_t* kept, int* tile_offsets, int* total,
                   void* stream) {
  if (n <= 0 || n >= (1LL << 31) || budget <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (n + kTile - 1) / kTile;
  count_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(valid, n,
                                                      tile_offsets);
  scan_tiles_kernel<<<1, kScanThreads, 0, st>>>(tile_offsets, (int)n_tiles,
                                                total);
  select_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(
      valid, n, tile_offsets, budget, sel, kept);
  const long long want = ((long long)budget + 255) / 256;
  const int fill_blocks = (int)(want < 1024 ? want : 1024);
  fill_kernel<<<fill_blocks, 256, 0, st>>>(sel, budget, total, (int)n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
