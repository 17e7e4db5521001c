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
// stable=True) gives, and every sum downstream keeps its order.
//
// What it sorts: keys [m] int32 and a key count n_keys. A key outside
// [0, n_keys) takes the drop value n_keys (K6's INT_MAX for a zero
// cotangent, K3's rows outside the table), so the sorted keys lie in
// [0, n_keys] and need bits = bit_length(n_keys) <= 31 bits, 17-23 on the
// train paths, where torch.sort passes over all 32 (and carries a 64-bit
// index). passes = ceil(bits / 9), each over a digit of ceil(bits /
// passes) bits (at most 9: 512 bins), lowest digit first: K6's 17-bit
// keys in 2 passes, the tri-plane's and hash4d's 22-23 bits in 3 of 8.
// Out: the keys sorted (dropped ones as n_keys, last) and perm [m] int32,
// the input index of each entry; equal keys keep ascending input order.
//
// A sort is one memset and 1 + passes kernels:
//   0. cudaMemsetAsync zeroes the tickets, the digit totals and the tiles'
//      status words: everything a sort counts on starting from zero, reset
//      on the device in the call that uses it (a CUDA graph captures it);
//   1. histogram_kernel reads the keys once and counts the digits of every
//      pass (shared-memory counts, then one integer atomicAdd a bin a
//      block: the same totals whatever order blocks run in). A later pass
//      reads no key twice: its totals come from this read;
//   2. pass_kernel, once a pass. A cluster of kCluster blocks (thread
//      block clusters, distributed shared memory) takes a tile of
//      kTileKeys consecutive keys from an atomic ticket, so every earlier
//      tile's cluster is already running. Each block ranks its kBlockKeys
//      keys stably by digit in registers (per round of 32 keys,
//      digit_peers gives the lanes that share a digit and the popcount of
//      the lower ones a lane's rank among them; per-warp counts in shared
//      memory carry it across rounds and warps) and publishes its digit
//      counts in shared memory; after a cluster barrier each block reads
//      the others' counts over DSMEM, so it knows where its keys of a digit
//      start in the cluster's tile sorted by digit. It puts its keys in
//      digit order in its own shared memory and copies them, (key, index)
//      pairs in order, into the slots of the tile in the shared memory of
//      the blocks that hold them: a digit's keys of a block go to
//      consecutive slots, so the remote stores are coalesced. The
//      cluster's threads also share out the digits, 4 lanes a digit: they
//      publish the tile's count of it (a 32-bit status word: flag and
//      count), find its place
//      among the earlier tiles by a decoupled look-back (look_back: the
//      lanes read the status words of the 16 nearest earlier tiles at once
//      and add their counts up to the first inclusive prefix; integer
//      sums, so the same offsets on every run), publish the tile's
//      inclusive prefix and hand every block of the cluster the global
//      position of the digit's run. The cluster stays resident and takes
//      the next tile's ticket as this one ends, so tiles run in ticket
//      order and its next keys load while it writes. After a second
//      barrier each block writes its kBlockKeys consecutive slots of the
//      sorted tile: a digit's run is the cluster's run, kCluster times as
//      long as one block's, so the stores fill whole 32-byte sectors. The
//      first pass reads the keys, maps them to the drop value and makes the
//      index itself; the passes between write (key, index) pairs to one of
//      two buffers; the last pass writes the sorted keys and perm, two
//      streams, directly (no split kernel).
// Forms measured slower on this card (PERF.md): before the clusters,
// 4,096 and 8,192 keys a block (128 registers: fewer blocks in flight),
// digits of 9 bits at 2,048 keys a block (runs half as long), a block's
// offsets found by a serial walk over every earlier block's counts; with
// them, clusters of 1, 2 or 4 blocks, digits of at most 8 bits, a tile a
// cluster launch (not resident), one remote store a key from registers,
// a thread a digit walking back, a look-back 8 or 16 deep or of more
// lanes, 64-bit status words, the next ticket taken as a tile starts,
// fewer histogram blocks, ranks by __match_any_sync.
//
// What bounds it on this card: the bytes, in principle. The histogram
// reads the keys (4 B a key); the first pass reads them (4 B) and writes
// pairs (8 B), a pass between reads and writes pairs (16 B), the last
// reads pairs and writes keys and perm (16 B): 16 B a key a pass in all,
// plus the status words (4 B a tile a digit a pass: zeroed, published
// twice, read). K6's 2.1 M keys in 2 passes: ~68 MB, ~20 us at 3.35 TB/s;
// the tri-plane's 25.2 M in 3: ~1.2 GB, ~0.36 ms. In practice a tile's
// turn is a chain of latencies (the loads, the ranks, two cluster
// barriers, DSMEM, the look-back), and 4 blocks an SM (64 registers, 48
// KB of shared memory each) do not hide them: a pass runs at about a
// third of the bytes' rate (PERF.md).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace keysort {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;                  // threads of a sort block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                      // keys a thread
constexpr int kBlockKeys = kThreads * kItems;  // keys a block: 2,048
constexpr int kBlockShift = 11;                // log2(kBlockKeys)
constexpr int kWarpKeys = 32 * kItems;         // keys a warp: 256
constexpr int kCluster = 8;                    // blocks a cluster
constexpr int kTileKeys = kCluster * kBlockKeys;  // keys a tile: 16,384
constexpr int kMaxDigitBits = 9;
constexpr int kBins = 1 << kMaxDigitBits;      // 512
constexpr int kDigitsPerThread = kBins / kThreads;
constexpr int kMaxPasses = 4;                  // ceil(31 / 8)
constexpr int kLookLanes = 4;     // lanes that look up one digit's offset
constexpr int kLookDepth = 4;     // status words a lane reads a round
constexpr int kHistThreads = 256;
constexpr int kHistKeys = 4096;    // keys a histogram block, at least
constexpr int kHistBlocks = 132 * 8;  // histogram blocks, at most
constexpr int kHistLoads = 8;      // loads a histogram thread keeps in flight
constexpr unsigned kFull = 0xffffffffu;
// a status word: 0 until published, then count + 1, with kPrefix set when
// the count is the tile's and all earlier tiles' (count + 1 < 2^31: m <
// 2^31 - 1)
constexpr unsigned kPrefix = 1u << 31;
constexpr unsigned kCount = kPrefix - 1u;
// the words the memset zeroes after the status words: the passes'
// tickets, then their digit totals
constexpr long long kControlWords = kMaxPasses + kMaxPasses * kBins;

static_assert(kBlockKeys == 1 << kBlockShift, "kBlockShift");
static_assert(kBins % kThreads == 0, "whole digits a thread");
static_assert(kThreads * kCluster / kLookLanes >= kBins,
              "a digit for every group of kLookLanes of the cluster's threads");
static_assert(kControlWords % 2 == 0, "the pair buffers 8-byte aligned");

struct Plan {
  int bits;         // bit_length(n_keys)
  int passes;       // ceil(bits / kMaxDigitBits)
  int digit_bits;   // ceil(bits / passes)
  long long tiles;  // ceil(m / kTileKeys)
};

inline Plan plan(long long m, int n_keys) {
  Plan p;
  p.bits = 0;
  while (p.bits < 31 && (1LL << p.bits) <= (long long)n_keys) ++p.bits;
  p.passes = (p.bits + kMaxDigitBits - 1) / kMaxDigitBits;
  p.digit_bits = (p.bits + p.passes - 1) / p.passes;
  p.tiles = (m + kTileKeys - 1) / kTileKeys;
  return p;
}

// int32 words of the part of the scratch the memset zeroes: the status
// words ([passes][tiles][1 << digit_bits]), then kControlWords
inline long long zeroed_words(const Plan& p) {
  return (long long)p.passes * p.tiles * (1LL << p.digit_bits) +
         kControlWords;
}

// int32 words of scratch a sort of m keys needs: the zeroed part, then the
// (key, index) pair buffers of the passes between the first and the last
// (none for one pass, one for two, two that alternate for more).
inline long long scratch_words(long long m, int n_keys) {
  const Plan p = plan(m, n_keys);
  const int buffers = p.passes < 2 ? 0 : (p.passes == 2 ? 1 : 2);
  return zeroed_words(p) + 2LL * m * buffers;
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

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

// hist [kMaxPasses][kBins] (zeroed): every pass's digit counts of the keys
// (mapped to the drop value), in one read.
__global__ void __launch_bounds__(kHistThreads)
    histogram_kernel(const int* __restrict__ keys, long long m, int n_keys,
                     int passes, int digit_bits, int* __restrict__ hist) {
  __shared__ int s_h[kMaxPasses * kBins];
  for (int i = threadIdx.x; i < passes * kBins; i += kHistThreads)
    s_h[i] = 0;
  __syncthreads();
  const int mask = (1 << digit_bits) - 1;
  const long long stride = (long long)gridDim.x * kHistThreads;
  for (long long p0 = (long long)blockIdx.x * kHistThreads + threadIdx.x;
       p0 < m; p0 += kHistLoads * stride) {
    int k[kHistLoads];
#pragma unroll
    for (int j = 0; j < kHistLoads; ++j) {
      const long long p = p0 + j * stride;
      k[j] = p < m ? map_key(__ldcs(keys + p), n_keys) : -1;
    }
#pragma unroll
    for (int j = 0; j < kHistLoads; ++j) {
      if (k[j] < 0) continue;
      for (int q = 0; q < passes; ++q)
        atomicAdd(&s_h[q * kBins + ((k[j] >> (q * digit_bits)) & mask)], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kBins; i += kHistThreads)
    if (s_h[i]) atomicAdd(hist + i, s_h[i]);
}

// The look-back of one digit by a group of kLookLanes lanes: the digit's
// count in the tiles before `tile`, from the status words of `status`
// ([tiles][sbins]). Each round the group reads the
// kLookLanes * kLookDepth nearest tiles not yet counted (lane k the k-th
// kLookDepth of them, its loads in flight together) and adds their counts,
// nearest first, up to the first inclusive prefix (done) or the first
// word not yet published (read again from there next round). Every lane
// of the warp must call it; `live` false: a group with nothing to look up.
__device__ __forceinline__ unsigned look_back(
    const unsigned* status, long long tile, int sbins, int digit,
    bool live) {
  const int sub = threadIdx.x & (kLookLanes - 1);
  bool done = !live || tile == 0;
  unsigned before = 0;
  long long near = tile - 1;  // the nearest tile not yet counted
  while (__any_sync(kFull, !done)) {
    unsigned acc = 0;
    int stop = 0, at = kLookDepth;  // stop: 1 a prefix, 2 a word not ready
    if (!done) {
      unsigned w[kLookDepth];
#pragma unroll
      for (int i = 0; i < kLookDepth; ++i) {
        const long long u = near - sub * kLookDepth - i;
        w[i] = u >= 0 ? load_status(status + u * sbins + digit)
                      : kPrefix | 1u;
      }
#pragma unroll
      for (int i = 0; i < kLookDepth; ++i) {
        if (stop) continue;
        if (w[i]) {
          acc += (w[i] & kCount) - 1u;
          if (w[i] & kPrefix) stop = 1;
        } else {
          stop = 2;
          at = i;
        }
      }
    }
    // the group's lanes in order, nearest first
    unsigned add = 0;
    int how = 0;
    long long next = near - kLookLanes * kLookDepth;
#pragma unroll
    for (int k = 0; k < kLookLanes; ++k) {
      const unsigned a = __shfl_sync(kFull, acc, k, kLookLanes);
      const int st = __shfl_sync(kFull, stop, k, kLookLanes);
      const int at_k = __shfl_sync(kFull, at, k, kLookLanes);
      if (how == 0) {
        add += a;
        how = st;
        if (st == 2) next = near - k * kLookDepth - at_k;
      }
    }
    if (!done) {
      before += add;
      done = how == 1;
      if (how == 2 && next == near) __nanosleep(64);  // nothing ready yet
      near = next;
    }
  }
  return before;
}

// A tile's keys a warp: a contiguous run of kWarpKeys, rounds of 32 in
// order (the first pass maps keys and makes the index, later ones read
// pairs).
template <bool First>
__device__ __forceinline__ void load_tile(int2 (&kv)[kItems],
                                          const int* keys, const int2* pairs,
                                          long long wbase, long long m,
                                          int n_keys) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long p = wbase + i * 32 + lane;
    kv[i] = make_int2(0, 0);
    if (p < m)
      kv[i] = First ? make_int2(map_key(__ldcs(keys + p), n_keys), (int)p)
                    : __ldcs(pairs + p);
  }
}

// One pass over the digit at `shift` (dbits bits; the plan's digit_bits
// wide rows of status, sbins = 1 << digit_bits). First: the input is keys
// (mapped here, the position as the index), else pairs. Last: the output
// is keys_out and perm, else pairs_out. hist: this pass's digit totals;
// status: this pass's [tiles][sbins] words; ticket: this pass's counter.
// A cluster stays resident and takes tiles from the ticket until none is
// left: the next tile's ticket is taken as this one's look-back ends, and
// its keys are loaded while this one is written out.
template <bool First, bool Last>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 4)
    pass_kernel(const int* __restrict__ keys, const int2* __restrict__ pairs,
                long long m, int n_keys, int shift, int dbits, int sbins,
                long long tiles, const int* __restrict__ hist,
                unsigned* __restrict__ status,
                int* __restrict__ ticket, int2* __restrict__ pairs_out,
                int* __restrict__ keys_out, int* __restrict__ perm) {
  // this block's keys sorted by digit, then this block's kBlockKeys slots
  // of the cluster's tile sorted by digit (the other blocks write them)
  __shared__ int2 s_loc[kBlockKeys];
  __shared__ int2 s_buf[kBlockKeys];
  __shared__ unsigned short s_wcnt[kWarps][kBins];  // per-warp digit
                                     // counts, then the warps' offsets
  __shared__ unsigned short s_cnt[kBins];  // this block's digit counts
  __shared__ short s_start[kBins];   // where a digit's keys start in s_loc,
                                     // then their slot in the tile less it
  __shared__ unsigned short s_tot[kBins];  // the tile's digit counts
  __shared__ int s_base[kBins];      // a digit's first global position
                                     // less its start in the tile
  __shared__ int s_gbase[kBins];     // a digit's global position less its
                                     // position in the tile (from the
                                     // block that looked it up)
  __shared__ int s_warp[kThreads / 32 + 1];
  __shared__ int s_ticket[2];        // block 0's: the next tile, by turns
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int mask = (1 << dbits) - 1;
  // the digit this thread looks up, kLookLanes lanes a digit
  const int own = (r * kThreads + (int)threadIdx.x) / kLookLanes;
  const int sub = threadIdx.x & (kLookLanes - 1);
  const unsigned lower = (1u << lane) - 1u;

  if (r == 0 && threadIdx.x == 0) s_ticket[0] = atomicAdd(ticket, 1);
  // the digits' totals over all keys -> each digit's first position
  int first[kDigitsPerThread];
  {
    int v = 0, sum;
#pragma unroll
    for (int j = 0; j < kDigitsPerThread; ++j) {
      const int d = threadIdx.x * kDigitsPerThread + j;
      first[j] = d <= mask ? __ldg(hist + d) : 0;
      v += first[j];
    }
    int base = block_exclusive_scan<kThreads>(v, s_warp, sum);
#pragma unroll
    for (int j = 0; j < kDigitsPerThread; ++j) {
      const int h = first[j];
      first[j] = base;
      base += h;
    }
  }
  cluster.sync();  // the first ticket
  int tile = *cluster.map_shared_rank(&s_ticket[0], 0);
  int2 kv[kItems];
  if (tile < tiles)
    load_tile<First>(kv, keys, pairs,
                     (long long)tile * kTileKeys + (long long)r * kBlockKeys
                         + (long long)w * kWarpKeys,
                     m, n_keys);
  for (int turn = 1; tile < tiles; turn ^= 1) {
    const long long tbase = (long long)tile * kTileKeys;
    const long long wbase = tbase + (long long)r * kBlockKeys +
                            (long long)w * kWarpKeys;
    const int n_mine = (int)max(0LL, min((long long)kBlockKeys,
                                         m - tbase - (long long)r *
                                                         kBlockKeys));
#pragma unroll
    for (int q = 0; q < kWarps; ++q)
#pragma unroll
      for (int j = 0; j < kDigitsPerThread; ++j)
        s_wcnt[q][threadIdx.x * kDigitsPerThread + j] = 0;
    __syncthreads();
    int rank[kItems];
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
    // and where the block's keys of it start in s_loc
    int lstart[kDigitsPerThread];
    {
      int c[kDigitsPerThread], v = 0, sum;
#pragma unroll
      for (int j = 0; j < kDigitsPerThread; ++j) {
        const int d = threadIdx.x * kDigitsPerThread + j;
        c[j] = 0;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) {
          const int x = s_wcnt[q][d];
          s_wcnt[q][d] = (unsigned short)c[j];
          c[j] += x;
        }
        s_cnt[d] = (unsigned short)c[j];
        v += c[j];
      }
      int start = block_exclusive_scan<kThreads>(v, s_warp, sum);
#pragma unroll
      for (int j = 0; j < kDigitsPerThread; ++j) {
        lstart[j] = start;
        s_start[threadIdx.x * kDigitsPerThread + j] = (short)start;
        start += c[j];
      }
    }
    cluster.sync();  // every block's digit counts (and s_start, s_wcnt)
    // this block's keys in digit order
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long p = wbase + i * 32 + lane;
      if (p < m) {
        const int digit = (kv[i].x >> shift) & mask;
        s_loc[s_start[digit] + s_wcnt[w][digit] + rank[i]] = kv[i];
      }
    }
    // the cluster's counts of this thread's digits: the tile's (tot) and
    // those of the blocks before this one (pre)
    {
      int tot[kDigitsPerThread], pre[kDigitsPerThread], v = 0, sum;
#pragma unroll
      for (int j = 0; j < kDigitsPerThread; ++j) {
        tot[j] = 0;
        pre[j] = 0;
      }
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        const unsigned short* cnt = cluster.map_shared_rank(s_cnt, q);
#pragma unroll
        for (int j = 0; j < kDigitsPerThread; ++j) {
          const int c = cnt[threadIdx.x * kDigitsPerThread + j];
          tot[j] += c;
          if (q < r) pre[j] += c;
        }
      }
      // where each digit's run starts in the sorted tile: the tile's
      // counts of the smaller digits (the scan's barriers also end the
      // loop above)
#pragma unroll
      for (int j = 0; j < kDigitsPerThread; ++j) v += tot[j];
      int start = block_exclusive_scan<kThreads>(v, s_warp, sum);
#pragma unroll
      for (int j = 0; j < kDigitsPerThread; ++j) {
        const int d = threadIdx.x * kDigitsPerThread + j;
        s_start[d] = (short)(start + pre[j] - lstart[j]);
        s_tot[d] = (unsigned short)tot[j];
        s_base[d] = first[j] - start;
        start += tot[j];
      }
    }
    __syncthreads();  // s_loc, s_start, s_tot, s_base
    unsigned* row = status + (long long)tile * sbins;
    if (sub == 0 && own < sbins)  // the tile's counts (tile 0's: a prefix)
      store_status(row + own, (tile == 0 ? kPrefix : 0u) |
                                  (s_tot[own] + 1u));
    // this block's keys to their slots of the sorted tile, in the blocks
    // that hold them: a digit's keys of this block go to consecutive slots
    for (int s = threadIdx.x; s < n_mine; s += kThreads) {
      const int2 q = s_loc[s];
      const int slot = s + s_start[(q.x >> shift) & mask];
      cluster.map_shared_rank(s_buf, slot >> kBlockShift)
          [slot & (kBlockKeys - 1)] = q;
    }
    {
      const unsigned before =
          look_back(status, tile, sbins, own, own < sbins);
      if (sub == 0 && tile > 0 && own < sbins)
        store_status(row + own, kPrefix | (before + s_tot[own] + 1u));
      const int gbase = s_base[own] + (int)before;
#pragma unroll
      for (int q = sub; q < kCluster; q += kLookLanes)
        cluster.map_shared_rank(s_gbase, q)[own] = gbase;
    }
    // the next tile's ticket, taken as this one ends: tiles start in
    // ticket order, so an earlier tile's counts are out when a later one
    // looks back
    if (r == 0 && threadIdx.x == 0) s_ticket[turn] = atomicAdd(ticket, 1);
    cluster.sync();  // the sorted tile, the digits' global positions and
                     // the next ticket
    const int next = *cluster.map_shared_rank(&s_ticket[turn], 0);
    if (next < tiles)  // its keys in flight while this tile is written
      load_tile<First>(kv, keys, pairs,
                       (long long)next * kTileKeys +
                           (long long)r * kBlockKeys +
                           (long long)w * kWarpKeys,
                       m, n_keys);
    // this block's slots of the sorted tile, in order: a digit's run is the
    // tile's, written to consecutive positions
    const long long n_tile = min((long long)kTileKeys, m - tbase);
    const int n_here =
        (int)max(0LL, min((long long)kBlockKeys, n_tile - (long long)r *
                                                            kBlockKeys));
    const int slot0 = r * kBlockKeys;
    for (int s = threadIdx.x; s < n_here; s += kThreads) {
      const int2 q = s_buf[s];
      const long long pos =
          (long long)s_gbase[(q.x >> shift) & mask] + slot0 + s;
      if (Last) {
        keys_out[pos] = q.x;
        perm[pos] = q.y;
      } else {
        pairs_out[pos] = q;
      }
    }
    tile = next;
  }
  cluster.sync();  // no block leaves while another may read its memory
}

// How many clusters of pass_kernel<First, Last> stay resident on the card
// at once (each takes tiles until none is left), asked once; a CUDA error
// as its negative.
template <bool First, bool Last>
inline int resident_clusters() {
  static const int n = [] {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster * 1024);
    cfg.blockDim = dim3(kThreads);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int c = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&c, pass_kernel<First, Last>, &cfg);
    if (e != cudaSuccess) return -static_cast<int>(e);
    return c > 0 ? c : -static_cast<int>(cudaErrorInvalidConfiguration);
  }();
  return n;
}

// One pass: as many clusters as stay resident, at most one a tile.
template <bool First, bool Last>
inline int launch_pass(const int* keys, const int2* in, long long m,
                       int n_keys, int shift, int dbits, int sbins,
                       long long tiles, const int* hist, unsigned* status,
                       int* ticket, int2* out, int* keys_out, int* perm,
                       cudaStream_t st) {
  const int resident = resident_clusters<First, Last>();
  if (resident < 0) return -resident;
  const long long clusters = min(tiles, (long long)resident);
  pass_kernel<First, Last><<<(unsigned)(clusters * kCluster), kThreads, 0,
                             st>>>(keys, in, m, n_keys, shift, dbits, sbins,
                                   tiles, hist, status, ticket, out,
                                   keys_out, perm);
  return static_cast<int>(cudaGetLastError());
}

// keys [m] i32 -> keys_out [m] i32 (sorted, outside [0, n_keys) as
// n_keys) and perm [m] i32 (input index of each entry), stable. scratch:
// scratch_words(m, n_keys) int32 words, 8-byte aligned. keys may not
// alias the outputs. Returns the first CUDA error of the memset and the
// launches, else cudaGetLastError().
inline int sort(const int* keys, long long m, int n_keys, int* keys_out,
                int* perm, int* scratch, cudaStream_t st) {
  if (m < 0 || m >= (1LL << 31) - 1 || n_keys <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const Plan p = plan(m, n_keys);
  const int sbins = 1 << p.digit_bits;
  const long long zeroed = zeroed_words(p);
  unsigned* status = reinterpret_cast<unsigned*>(scratch);
  int* tickets = scratch + (zeroed - kControlWords);
  int* hist = tickets + kMaxPasses;
  int2* buf[2] = {reinterpret_cast<int2*>(scratch + zeroed),
                  reinterpret_cast<int2*>(scratch + zeroed) + m};
  cudaError_t err = cudaMemsetAsync(scratch, 0, zeroed * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long hblocks =
      max(1LL, min((m + kHistKeys - 1) / kHistKeys, (long long)kHistBlocks));
  histogram_kernel<<<(unsigned)hblocks, kHistThreads, 0, st>>>(
      keys, m, n_keys, p.passes, p.digit_bits, hist);
  const int2* in = nullptr;
  for (int pass = 0; pass < p.passes; ++pass) {
    const int shift = pass * p.digit_bits;
    const int dbits = min(p.digit_bits, p.bits - shift);
    const bool first = pass == 0, last = pass == p.passes - 1;
    int2* out = last ? nullptr : buf[pass & 1];
    unsigned* st_pass = status + (long long)pass * p.tiles * sbins;
    const int* h = hist + pass * kBins;
    int* tk = tickets + pass;
    const int rc =
        first && last
            ? launch_pass<true, true>(keys, in, m, n_keys, shift, dbits,
                                      sbins, p.tiles, h, st_pass, tk, out,
                                      keys_out, perm, st)
        : first ? launch_pass<true, false>(keys, in, m, n_keys, shift, dbits,
                                           sbins, p.tiles, h, st_pass, tk,
                                           out, keys_out, perm, st)
        : last ? launch_pass<false, true>(keys, in, m, n_keys, shift, dbits,
                                          sbins, p.tiles, h, st_pass, tk,
                                          out, keys_out, perm, st)
               : launch_pass<false, false>(keys, in, m, n_keys, shift, dbits,
                                           sbins, p.tiles, h, st_pass, tk,
                                           out, keys_out, perm, st);
    if (rc != 0) return rc;
    in = out;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace keysort
