// The fixed-order sum by key that the table-gradient kernels share
// (csrc/brick_encode_bwd.cu: K6, K6c, K2; csrc/scatter_add_rows.cu: K3).
//
// The TPU kernels add a table gradient in one order on every run: one core
// walks the sample tiles in order (cednerf_tpu/ops/pallas_scatter.py
// accum_rows_aligned adds the rows of a tile one after another), and the
// XLA scatter-add the JAX package falls back to is deterministic. Blocks on
// this card run in no order, and f32 atomics add in the order they land,
// which changes from run to run. Here the terms are put in a fixed order
// first and then summed without atomics:
//
//   1. keys: one int32 per term (a (sample, level) or an update row), the
//      row of the output it adds into; a key outside the destination's rows
//      is dropped (the K6 family writes INT_MAX for a zero cotangent);
//   2. a stable sort of the keys (csrc/key_sort.cuh: an integer
//      permutation, int32: equal keys keep their input order, so any
//      correct sort gives the same permutation, torch.sort(stable=True)'s
//      among them);
//   3. the reduce: the sorted entries in tiles of `tile` consecutive
//      entries (the wrappers' REDUCE_TILE, ops/scatter_kernels.py; K3's
//      narrow rows NARROW_TILE), one warp a tile (K3's narrow rows: a few
//      threads a tile), each run of equal keys summed in sorted order
//      (ascending input order) from 0. A run that lies inside its tile
//      goes to its output row from that warp alone: a
//      plain store, or where the destination accumulates (Dest::add) one
//      plain read-modify-write a lane. A run that crosses a tile edge
//      leaves a partial row instead: the tile where it begins its `tail`,
//      each later tile it covers its `head`;
//   4. the carry pass (carry_kernel): the first tile of each crossing run
//      adds tail + head + head + ... in tile order and writes that to the
//      output row in the same way. No decoupled look-back and no atomics:
//      cub's single-pass float scan, which does combine partials by
//      look-back, is what made the port's 1-D scans differ from run to run.
//
// A key's row is written by one thread a lane, once, so a store needs no
// read: the K6 family's destinations are zero where a key lands (the table
// gradient is filled with zeros, K6c's cell rows are its resident zero
// buffer), K3's are zeroed unless the caller adds into its own buffer.
//
// So a key's sum is ((t_0 + t_1) + ...) within a tile and the tiles' sums in
// tile order: the strict input order (the TPU kernel's and CPU index_add_'s)
// whenever a run lies inside one tile, a fixed two-level order otherwise.
// Strict order across tiles would chain a whole run through one warp: on a
// batch whose 262,144 samples all lie in one level-0 brick that is one chain
// of 262,144 dependent adds; two levels cap the chain at one tile plus one
// add a tile it covers (chip_smoke.py phase 18 times both).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ordered {

constexpr int kCarryThreads = 128;
constexpr int kCarryDepth = 32;     // head rows a carry thread loads at once
constexpr unsigned kFull = 0xffffffffu;

// Output rows of a key: keys [0, n_a) are rows of a (w_a f32 lanes), keys
// [n_a, n_a + n_b) rows of b (w_b lanes); any other key is dropped. add:
// a key's sum is added to what its row holds, else stored over it.
struct Dest {
  float* a;
  long long n_a;
  int w_a;
  float* b;
  long long n_b;
  int w_b;
  bool add;
  __device__ __forceinline__ bool valid(int k) const {
    return k >= 0 && (long long)k < n_a + n_b;
  }
  __device__ __forceinline__ float* row(int k) const {
    return k < n_a ? a + (long long)k * w_a : b + ((long long)k - n_a) * w_b;
  }
  __device__ __forceinline__ int width(int k) const {
    return k < n_a ? w_a : w_b;
  }
};

// Tile t of the sorted entries: [s, e) and the keys just outside it.
struct Tile {
  long long s, e;
  bool has_prev, has_next;
  int prev, next;
};

__device__ __forceinline__ Tile tile_of(const int* keys, long long n_entries,
                                        long long t, int tile) {
  Tile tl;
  tl.s = t * tile;
  tl.e = min(tl.s + tile, n_entries);
  tl.has_prev = tl.s > 0;
  tl.has_next = tl.e < n_entries;
  tl.prev = tl.has_prev ? __ldg(keys + tl.s - 1) : 0;
  tl.next = tl.has_next ? __ldg(keys + tl.e) : 0;
  return tl;
}

// Where the run [a, b) of key k in tile tl goes: 0 its output row (it lies
// inside the tile), 1 the tile's head partial (it began in an earlier
// tile), 2 the tile's tail partial (it begins here and goes on).
__device__ __forceinline__ int run_target(const Tile& tl, long long a,
                                          long long b, int k) {
  if (a == tl.s && tl.has_prev && tl.prev == k) return 1;
  if (b == tl.e && tl.has_next && tl.next == k) return 2;
  return 0;
}

// The carry pass: part [2, tiles, pw] f32 holds the heads, then the tails.
// Block t acts when tile t holds the first partial of a run that crosses
// its end (most tiles hold none and their blocks return at once): it
// finds the run's last tile by a search of the tiles' first keys and adds
// the partials in tile order, a column a thread, kCarryDepth loads in
// flight. A block a tile keeps the chains in parallel: 32 tiles a block,
// their chains one after another, took 0.29 ms against this form's 0.15
// on uniform samples (chip_smoke.py phase 18, an H100 80GB HBM3 at 700 W).
__global__ void __launch_bounds__(kCarryThreads)
    carry_kernel(const int* __restrict__ keys, long long n_entries, int tile,
                 const float* __restrict__ part, long long tiles, int pw,
                 Dest d) {
  const long long t = blockIdx.x;
  const long long s = t * tile;
  const long long e = min(s + tile, n_entries);
  if (e >= n_entries) return;
  const int k = __ldg(keys + e - 1);
  if (__ldg(keys + e) != k || !d.valid(k)) return;
  if (s > 0 && __ldg(keys + s) == k && __ldg(keys + s - 1) == k) return;
  // The run's last tile: the last whose first key is k (tile t + 1's is,
  // as e = (t + 1) * tile). A gallop over the tiles' first keys, then a
  // bisection: a run over u tiles takes ~2 log2(u) dependent loads, where
  // a bisection of all the entries after e took ~log2(n_entries): 1.03
  // device-ms of a tri-plane train step (profile_training.py --triplane,
  // an H100 80GB HBM3 at 700 W).
  long long lo = t + 1, hi = t + 2;  // lo's first key is k; hi: past it
  for (long long step = 1; hi < tiles && __ldg(keys + hi * tile) == k;) {
    lo = hi;
    step <<= 1;
    hi = lo + step;
  }
  hi = min(hi, tiles);
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (__ldg(keys + mid * tile) == k) lo = mid; else hi = mid;
  }
  const long long last = lo;
  const float* head = part;
  const float* tail = part + tiles * pw;
  float* dst = d.row(k);
  const int w = d.width(k);
  for (int c = threadIdx.x; c < w; c += kCarryThreads) {
    float acc = tail[t * pw + c];
    for (long long u = t + 1; u <= last; u += kCarryDepth) {
      float v[kCarryDepth];
#pragma unroll
      for (int j = 0; j < kCarryDepth; ++j)
        v[j] = u + j <= last ? head[(u + j) * pw + c] : 0.0f;
#pragma unroll
      for (int j = 0; j < kCarryDepth; ++j)
        if (u + j <= last) acc = __fadd_rn(acc, v[j]);
    }
    dst[c] = d.add ? __fadd_rn(dst[c], acc) : acc;
  }
}

inline int launch_carry(const int* keys, long long n_entries, int tile,
                        const float* part, long long tiles, int pw,
                        const Dest& d, cudaStream_t st) {
  if (tiles > 0)
    carry_kernel<<<(unsigned)tiles, kCarryThreads, 0, st>>>(
        keys, n_entries, tile, part, tiles, pw, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ordered
