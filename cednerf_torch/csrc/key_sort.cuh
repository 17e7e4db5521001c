// A stable LSD radix sort of int32 keys over the bits they use, with an
// int32 index: the sort in front of the ordered reduce (csrc/
// ordered_reduce.cuh) of K6, K6c, K2 (csrc/brick_encode_bwd.cu) and K3
// (csrc/scatter_add_rows.cu). Each of the two libraries includes it and
// exports it as `key_sort`; ops/scatter_kernels.py's key_sort launches it
// and key_sort_plain is its plain version, pass by pass.
//
// It replaces no TPU kernel: the TPU kernels sum a table gradient in one
// order by walking the sample tiles on one core. Here the terms are put in
// order first, and that takes a stable sort of their keys (one int32 a
// term: the output row it adds into). A stable sort of integer keys has
// exactly one permutation, so this sort gives the bits torch.sort(
// stable=True) gave before it, and every sum downstream keeps its order.
//
// What it sorts: keys [m] int32 and a key count n_keys. A key outside
// [0, n_keys) takes the drop value n_keys (K6's INT_MAX for a zero
// cotangent, K3's rows outside the table), so the sorted keys lie in
// [0, n_keys] and need bits = bit_length(n_keys) <= 31 bits, 17-23 on the
// train paths, where torch.sort passes over all 32 (and carries a 64-bit
// index). passes = ceil(bits / 8), each over a digit of ceil(bits /
// passes) bits (at most 8: 256 bins), lowest digit first. Out: the keys
// sorted (dropped ones as n_keys, last) and perm [m] int32, the input
// index of each entry; equal keys keep ascending input order.
//
// A pass is three kernels:
//   1. histogram_kernel: a block of kThreads threads counts the digits of
//      kBlockKeys consecutive keys in shared memory (warp-aggregated: one
//      add for each group of lanes with one digit, digit_peers) and
//      writes its counts as one contiguous row, counts[block][digit];
//   2. scan_kernel: a block a digit turns that digit's counts over the
//      blocks into exclusive offsets in block order and writes the digit's
//      total. All integer: the same offsets on every run, whatever order
//      blocks run in;
//   3. scatter_kernel: a block ranks its keys stably with warp-level
//      ranks (per round of 32 keys, digit_peers gives the lanes that share
//      a digit and the popcount of the lower ones a lane's rank among
//      them; a per-warp count in shared memory carries it across rounds,
//      the warps' counts are scanned across warps), places them by digit
//      in shared memory, and writes them out in that order as (key, index)
//      pairs: a digit's keys of a block go to consecutive positions, its
//      offset from the scan plus the totals of the smaller digits. The
//      first pass reads the keys, maps them to the drop value and makes
//      the index itself (no iota tensor).
// The passes alternate between two pair buffers in the scratch; then
// split_kernel writes the last pass's pairs to the two outputs. One
// stream of 8-byte pairs, not keys and indices as two streams: a digit's
// run of a block is a few keys, so two streams leave twice the partial
// 32-byte sectors that the L2 must merge before they go to memory, and on
// this card a pass took several times as long that way (PERF.md). Reads
// that are used once stream past the L2 (__ldcs), which keeps it for
// those partial sectors. A block takes 2,048 keys, 8 a thread: the
// scatter then fits in 64 registers, and more blocks in flight hide its
// loads and barriers. Forms measured slower on this card (PERF.md): 4,096
// and 8,192 keys a block (128 registers: fewer blocks in flight, though
// a digit's runs are longer); digits of up to 9 bits (K6's 17-bit keys in
// 2 passes, but runs half as long); every pass's digits counted in one
// read and a block's offsets found by a walk back over the earlier
// blocks' published counts (one kernel a pass: the walk's serial loads).
//
// What bounds it on this card: the bytes. A pass reads the keys twice (the
// histogram, the scatter: 4 + 4 B in the first pass, 8 + 8 B of pairs
// after it) and writes the pairs (8 B), plus the block counts and offsets
// (4 B a bin a block each, written and read); the split reads the pairs
// and writes keys and index (16 B). At 2,097,152 keys and 3 passes ~135
// MB, ~40 us at 3.35 TB/s; at the tri-plane's 25,165,824 ~1.6 GB, ~0.48
// ms. torch.sort passes four times over 32-bit keys with a
// 64-bit index.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace keysort {

constexpr int kThreads = 256;                  // threads of a sort block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                      // keys a thread
constexpr int kBlockKeys = kThreads * kItems;  // keys a block: 2,048
constexpr int kWarpKeys = 32 * kItems;         // keys a warp: 256
constexpr int kMaxDigitBits = 8;
constexpr int kBins = 1 << kMaxDigitBits;      // 256 = kThreads
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBins == kThreads, "a thread a digit in the block scans");

struct Plan {
  int bits;         // bit_length(n_keys)
  int passes;       // ceil(bits / 8)
  int digit_bits;   // ceil(bits / passes)
  long long blocks; // ceil(m / kBlockKeys)
};

inline Plan plan(long long m, int n_keys) {
  Plan p;
  p.bits = 0;
  while (p.bits < 31 && (1LL << p.bits) <= (long long)n_keys) ++p.bits;
  p.passes = (p.bits + kMaxDigitBits - 1) / kMaxDigitBits;
  p.digit_bits = (p.bits + p.passes - 1) / p.passes;
  p.blocks = (m + kBlockKeys - 1) / kBlockKeys;
  return p;
}

// int32 words of scratch a sort of m keys needs: two buffers of (key,
// index) pairs, the blocks' digit counts, their offsets, the digit totals.
inline long long scratch_words(long long m, int n_keys) {
  const Plan p = plan(m, n_keys);
  return 4 * m + 2LL * kBins * p.blocks + kBins;
}

__device__ __forceinline__ int map_key(int k, int n_keys) {
  return (k >= 0 && k < n_keys) ? k : n_keys;
}

// The lanes of `live` whose digit (dbits bits) equals this lane's: one
// __ballot_sync a bit, each ANDed in as is or inverted (what
// __match_any_sync gives, in dbits ballots). Every lane must call it.
__device__ __forceinline__ unsigned digit_peers(int digit, int dbits,
                                                unsigned live) {
  unsigned peers = live;
#pragma unroll
  for (int b = 0; b < kMaxDigitBits; ++b) {
    if (b < dbits) {
      const bool bit = (digit >> b) & 1;
      const unsigned bal = __ballot_sync(kFull, bit);
      peers &= bit ? bal : ~bal;
    }
  }
  return peers;
}

// Exclusive scan of one int a thread over a block of NT threads (NT / 32
// warps); s_warp holds NT / 32 + 1 ints. Returns the thread's exclusive
// prefix and sets total to the block's sum. Every thread must call it.
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[w] = incl;
  __syncthreads();
  if (w == 0) {
    int s = lane < NT / 32 ? s_warp[lane] : 0;
    int si = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, si, o);
      if (lane >= o) si += y;
    }
    if (lane < NT / 32) s_warp[lane] = si - s;  // exclusive warp offsets
    if (lane == 31) s_warp[NT / 32] = si;       // the block's sum
  }
  __syncthreads();
  const int out = incl - v + s_warp[w];
  total = s_warp[NT / 32];
  __syncthreads();  // s_warp may be reused by the caller
  return out;
}

// A key of the first pass (keys [m] int32, mapped to the drop value) or of
// a later one (pairs [m] int2: (key, index), mapped already).
__device__ __forceinline__ int load_key(const int* keys, const int2* pairs,
                                        long long p, int n_keys) {
  return pairs ? __ldcs(pairs + p).x : map_key(__ldcs(keys + p), n_keys);
}

// counts [blocks, kBins] (block-major: a block writes one contiguous row)
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const int* __restrict__ keys,
                     const int2* __restrict__ pairs, long long m, int n_keys,
                     int shift, int dbits, int* __restrict__ counts) {
  __shared__ int s_cnt[kBins];
  const int lane = threadIdx.x & 31;
  s_cnt[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kBlockKeys;
  const int mask = (1 << dbits) - 1;
#pragma unroll 4
  for (int i = 0; i < kItems; ++i) {
    const long long p = base + (long long)i * kThreads + threadIdx.x;
    const int digit =
        p < m ? (load_key(keys, pairs, p, n_keys) >> shift) & mask : 0;
    const unsigned peers =
        digit_peers(digit, dbits, __ballot_sync(kFull, p < m));
    if (p < m && lane == __ffs(peers) - 1)
      atomicAdd(&s_cnt[digit], __popc(peers));
  }
  __syncthreads();
  counts[(long long)blockIdx.x * kBins + threadIdx.x] = s_cnt[threadIdx.x];
}

// Block d: digit d's counts over the blocks (column d of counts) ->
// offsets[d * blocks + b], their exclusive scan in block order (a row a
// digit, written contiguously); totals[d] their sum.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const int* __restrict__ counts, long long blocks,
                int* __restrict__ offsets, int* __restrict__ totals) {
  __shared__ int s_warp[kScanThreads / 32 + 1];
  int* row = offsets + (long long)blockIdx.x * blocks;
  int carry = 0;
  for (long long b0 = 0; b0 < blocks; b0 += kScanThreads) {
    const long long b = b0 + threadIdx.x;
    const int v = b < blocks ? counts[b * kBins + blockIdx.x] : 0;
    int total;
    const int ex = block_exclusive_scan<kScanThreads>(v, s_warp, total);
    if (b < blocks) row[b] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// One pass: the keys of block blockIdx.x (keys, the first pass's input,
// with the position as the index; else pairs) ranked stably by digit and
// written as (key, index) pairs to their sorted positions: one output
// stream of 8-byte pairs, a digit's run of a block one piece of pairs_out
// (see the note at the top).
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int* __restrict__ keys,
                   const int2* __restrict__ pairs, long long m, int n_keys,
                   int shift, int dbits, const int* __restrict__ offsets,
                   const int* __restrict__ totals, long long blocks,
                   int2* __restrict__ pairs_out) {
  __shared__ int2 s_pairs[kBlockKeys];
  __shared__ unsigned short s_wcnt[kWarps][kBins];  // per-warp digit
                                     // counts, then the warps' offsets
  __shared__ int s_start[kBins];     // a digit's first slot in s_pairs
  __shared__ int s_gbase[kBins];     // its first output position
  __shared__ int s_warp[kThreads / 32 + 1];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int mask = (1 << dbits) - 1;
  const int bins = mask + 1;
  const long long base = (long long)blockIdx.x * kBlockKeys;
  const int n_here = (int)min((long long)kBlockKeys, m - base);

  // the digits' first output positions: the totals of the smaller digits
  // plus this block's offset within its digit (thread d: digit d)
  {
    const int d = threadIdx.x;
    const int tot = d < bins ? __ldg(totals + d) : 0;
    int sum;
    const int ex = block_exclusive_scan<kThreads>(tot, s_warp, sum);
    s_gbase[d] = d < bins ? ex + __ldg(offsets + (long long)d * blocks +
                                       blockIdx.x)
                          : 0;
  }
#pragma unroll
  for (int q = 0; q < kWarps; ++q) s_wcnt[q][threadIdx.x] = 0;
  __syncthreads();

  // keys a warp: a contiguous run of kWarpKeys, rounds of 32 in order
  int2 kv[kItems];
  int rank[kItems];
  const long long wbase = base + (long long)w * kWarpKeys;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long p = wbase + i * 32 + lane;
    kv[i] = make_int2(0, 0);
    if (p < m)
      kv[i] = pairs ? __ldcs(pairs + p)
                    : make_int2(map_key(__ldcs(keys + p), n_keys), (int)p);
  }
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long p = wbase + i * 32 + lane;
    const int digit = (kv[i].x >> shift) & mask;
    const unsigned peers =
        digit_peers(digit, dbits, __ballot_sync(kFull, p < m));
    int before = 0;
    if (p < m) before = s_wcnt[w][digit];
    __syncwarp();
    if (p < m && lane == __ffs(peers) - 1)
      s_wcnt[w][digit] = (unsigned short)(before + __popc(peers));
    __syncwarp();
    rank[i] = before + __popc(peers & lower);
  }
  __syncthreads();
  // per digit: the warps' counts to exclusive offsets, the block's count
  // scanned over the digits
  {
    const int d = threadIdx.x;
    int c = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const int v = s_wcnt[q][d];
      s_wcnt[q][d] = (unsigned short)c;
      c += v;
    }
    int sum;
    s_start[d] = block_exclusive_scan<kThreads>(d < bins ? c : 0, s_warp,
                                                sum);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long p = wbase + i * 32 + lane;
    if (p < m) {
      const int digit = (kv[i].x >> shift) & mask;
      s_pairs[s_start[digit] + s_wcnt[w][digit] + rank[i]] = kv[i];
    }
  }
  __syncthreads();
  // in digit order: a digit's keys of this block to consecutive positions
  for (int s = threadIdx.x; s < n_here; s += kThreads) {
    const int2 q = s_pairs[s];
    const int digit = (q.x >> shift) & mask;
    pairs_out[(long long)s_gbase[digit] + (s - s_start[digit])] = q;
  }
}

// The sorted pairs to the two outputs.
__global__ void __launch_bounds__(kThreads)
    split_kernel(const int2* __restrict__ pairs, long long m,
                 int* __restrict__ keys_out, int* __restrict__ perm) {
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < m;
       p += (long long)gridDim.x * kThreads) {
    const int2 q = __ldcs(pairs + p);
    keys_out[p] = q.x;
    perm[p] = q.y;
  }
}

// keys [m] i32 -> keys_out [m] i32 (sorted, outside [0, n_keys) as
// n_keys) and perm [m] i32 (input index of each entry), stable. scratch:
// scratch_words(m, n_keys) int32 words, 8-byte aligned. keys may not
// alias the outputs. Returns cudaGetLastError() after the launches.
inline int sort(const int* keys, long long m, int n_keys, int* keys_out,
                int* perm, int* scratch, cudaStream_t st) {
  if (m < 0 || m >= (1LL << 31) || n_keys <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const Plan p = plan(m, n_keys);
  int2* buf[2] = {reinterpret_cast<int2*>(scratch),
                  reinterpret_cast<int2*>(scratch) + m};
  int* counts = scratch + 4 * m;
  int* offsets = counts + (long long)kBins * p.blocks;
  int* totals = offsets + (long long)kBins * p.blocks;
  const int2* in = nullptr;  // the first pass reads keys
  for (int pass = 0; pass < p.passes; ++pass) {
    const int shift = pass * p.digit_bits;
    const int dbits = min(p.digit_bits, p.bits - shift);
    int2* out = buf[pass & 1];
    histogram_kernel<<<(unsigned)p.blocks, kThreads, 0, st>>>(
        keys, in, m, n_keys, shift, dbits, counts);
    scan_kernel<<<1u << dbits, kScanThreads, 0, st>>>(counts, p.blocks,
                                                      offsets, totals);
    scatter_kernel<<<(unsigned)p.blocks, kThreads, 0, st>>>(
        keys, in, m, n_keys, shift, dbits, offsets, totals, p.blocks, out);
    in = out;
  }
  const long long grid = min((m + kThreads - 1) / kThreads, 132LL * 16);
  split_kernel<<<(unsigned)grid, kThreads, 0, st>>>(in, m, keys_out, perm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace keysort
