// The fixed-order sum by key that the table-gradient kernels share
// (csrc/brick_encode_bwd.cu: K6, K6c, K2; csrc/scatter_add_rows.cu: K3).
//
// The TPU kernels add a table gradient in one order on every run: one core
// walks the sample tiles in order (cednerf_tpu/ops/pallas_scatter.py
// accum_rows_aligned adds the rows of a tile one after another), and the
// XLA scatter-add the JAX package falls back to is deterministic. Blocks on
// this card run in no order, and f32 atomics add in the order they land,
// which changes from run to run. Here the terms are put in a fixed order
// first and then summed without float atomics:
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
//      narrow rows NARROW_TILE), one warp a tile (K3: a warp a tile and
//      column chunk, or for narrow rows one thread a tile and column), each
//      run of equal keys summed in sorted order (ascending input order)
//      from 0. A run that lies inside its tile goes to its output row from
//      that tile alone: a plain store, or where the destination
//      accumulates (Dest::add) one plain read-modify-write. A run that
//      crosses a tile edge leaves a partial row instead: the tile where it
//      begins its `tail`, each later tile it covers its `head`;
//   4. the carry, folded into the same launch (fold_carry below): a tile
//      that left a partial of a crossing run counts its arrival on the
//      run's first tile with one integer atomicAdd, and whoever arrives
//      last adds tail + head + head + ... in tile order and writes that to
//      the output row in the same way. Nothing waits for another block, so
//      progress never depends on which blocks are resident; no look-back
//      (cub's single-pass float scan, which combines partials by
//      look-back, is what made the port's 1-D scans differ from run to
//      run), and the only atomic is the arrival count.
//
// A key's row is written by one thread a column, once, so a store needs no
// read: K6c's cell rows are its resident zero buffer and K3's output is
// zeroed unless the caller adds into its own buffer; the K6 family's table
// gradient is not filled at all, its reduce writes zeros into the rows no
// key lands on (csrc/brick_encode_bwd.cu).
//
// So a key's sum is ((t_0 + t_1) + ...) within a tile and the tiles' sums in
// tile order: the strict input order (the TPU kernel's and CPU index_add_'s)
// whenever a run lies inside one tile, a fixed two-level order otherwise.
// Strict order across tiles would chain a whole run through one warp: on a
// batch whose 262,144 samples all lie in one level-0 brick that is one chain
// of 262,144 dependent adds; two levels cap the chain at one tile plus one
// add a tile it covers (chip_smoke.py phase 18 times both).
//
// The arrival counters: an int32 a (run's first tile, column group) in a
// buffer that the wrappers keep resident per (device, stream), zero
// between calls (ops/scatter_kernels.py carry_counts): the last arriver
// puts its counter back to 0, so no call fills it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ordered {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChainLoads = 32;  // partial-row values a thread of the last
                                 // arriver loads at once

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

// The partial rows and arrival counters of a launch: part [2, tiles, pw]
// f32 (the heads, then the tails), count the resident counters, `groups`
// of them a tile (column groups that arrive apart).
struct Carry {
  float* part;
  int pw;
  int* count;
  int groups;
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

// The last tile of a run of key k given that tile u's first key is k: the
// last whose first key is k. `probe` is tile u + 1's first key (any value
// when u + 1 == tiles), loaded ahead by the caller. A gallop over the
// tiles' first keys, then a bisection: a run over v tiles takes ~2
// log2(v) dependent loads, where a bisection of all the entries after it
// took ~log2(n_entries): 1.03 device-ms of a tri-plane train step
// (profile_training.py --triplane, an NVIDIA H100 80GB HBM3 at 700 W).
__device__ __forceinline__ long long last_tile(const int* keys, int tile,
                                               long long tiles, long long u,
                                               int k, int probe) {
  if (u + 1 >= tiles || probe != k) return u;
  long long lo = u + 1, hi = u + 2;  // lo's first key is k; hi: past the run
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
  return lo;
}

// The tile where the run of key k begins, given that it covers the first
// entry of tile u > 0 and the entry before it; `probe` is tile u - 1's
// first key. The same gallop backwards to the first tile whose first key
// is k, then one step back: the run covers the end of the tile before it.
__device__ __forceinline__ long long first_tile(const int* keys, int tile,
                                                long long u, int k,
                                                int probe) {
  if (probe != k) return u - 1;
  long long hi = u - 1, lo = u - 2;  // hi's first key is k; lo's not, or -1
  for (long long step = 1; lo >= 0 && __ldg(keys + lo * tile) == k;) {
    hi = lo;
    step <<= 1;
    lo = hi - step;
  }
  lo = max(lo, -1ll);
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (__ldg(keys + mid * tile) == k) hi = mid; else lo = mid;
  }
  return hi > 0 && __ldg(keys + hi * tile - 1) == k ? hi - 1 : hi;
}

// The crossing runs of tile t: its head run (its first, begun in an
// earlier tile) and its tail run (its last, begun here and going on past
// its end), each with its key and first and last tiles. Found when the
// tile's reduce begins, so that the loads of the keys they need (the
// tile's first and last, the first keys of tiles t - 1 and t + 2) are in
// flight together and a run over few tiles needs no more.
struct Run {
  bool on;
  int key;
  long long t0, t1;
};

struct Runs {
  Run head, tail;
};

__device__ __forceinline__ Runs crossing_runs(const int* keys, const Tile& tl,
                                              long long t, int tile,
                                              long long tiles,
                                              const Dest& d) {
  const int first = __ldg(keys + tl.s), last = __ldg(keys + tl.e - 1);
  const int back = t > 0 ? __ldg(keys + (t - 1) * tile) : 0;
  const int fwd = t + 2 < tiles ? __ldg(keys + (t + 2) * tile) : 0;
  const bool goes_on = tl.has_next && tl.next == last;
  Runs r;
  r.head.on = tl.has_prev && tl.prev == first && d.valid(first);
  r.head.key = first;
  r.head.t0 = r.head.t1 = t;
  if (r.head.on) {
    r.head.t0 = first_tile(keys, tile, t, first, back);
    if (first == last && goes_on)
      r.head.t1 = last_tile(keys, tile, tiles, t + 1, first, fwd);
  }
  r.tail.on = goes_on && d.valid(last) && !(r.head.on && first == last);
  r.tail.key = last;
  r.tail.t0 = r.tail.t1 = t;
  if (r.tail.on) r.tail.t1 = last_tile(keys, tile, tiles, t + 1, last, fwd);
  return r;
}

// A crossing run's sum over its partials, at the columns c0 + j * cstep
// (j < NC) below w: the tail partial of tile t0 plus the head partials of
// tiles t0 + 1 .. t1, added in tile order (carry_plain's order), stored into
// dst (add: added to what it holds). kChainLoads values in flight a thread;
// the partials are read through the L2 (other SMs wrote them).
template <int NC>
__device__ __forceinline__ void chain_sum(const Carry& c, long long tiles,
                                          const Run& r, int c0, int cstep,
                                          int w, float* dst, bool add) {
  constexpr int kDepth = kChainLoads / NC;
  const float* head = c.part;
  const float* tail = c.part + tiles * c.pw;
  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = c0 + j * cstep;
    acc[j] = col < w ? __ldcg(tail + r.t0 * c.pw + col) : 0.0f;
  }
  for (long long u = r.t0 + 1; u <= r.t1; u += kDepth) {
    float v[kDepth][NC];
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = c0 + j * cstep;
        v[i][j] = u + i <= r.t1 && col < w
                      ? __ldcg(head + (u + i) * c.pw + col)
                      : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      if (u + i <= r.t1) {
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] = __fadd_rn(acc[j], v[i][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = c0 + j * cstep;
    if (col < w) dst[col] = add ? __fadd_rn(dst[col], acc[j]) : acc[j];
  }
}

// The folded carry of a tile at the end of its reduce, once its partial
// rows are stored: for each crossing run it left a partial of (runs,
// crossing_runs), count its arrival at counter slot (run's first tile) *
// groups + group; whoever arrives last of the run's t1 - t0 + 1 tiles
// puts that counter back to 0 and stores the run's sum at the columns c0 +
// j * cstep (j < NC). Each partial is visible to it by the fence-atomic-
// fence pattern in the thread that counts: a fence after the partials'
// stores and before the count (release), a fence after the count that
// comes last and before the partials are read (acquire). kWarp: the whole
// warp stored the partials and arrives once (all 32 lanes call this
// together): a __syncwarp orders the lanes' stores before lane 0's release
// fence and count, and lane 0's acquire fence before the lanes' reads;
// else one thread arrives for its own column. No thread waits for
// another. One fence and the tile's atomics together at its end, with the
// runs' spans found when the tile began: a fence, an atomic and the span
// searches a run after the adds, the fold's first form, was slower.
template <int NC, bool kWarp>
__device__ __forceinline__ void fold_carry(const Runs& runs, long long tiles,
                                           const Dest& d, const Carry& c,
                                           int group, int c0, int cstep) {
  const Run& h = runs.head;
  const Run& tl = runs.tail;
  if (!h.on && !tl.on) return;
  int* ch = c.count + h.t0 * c.groups + group;
  int* ct = c.count + tl.t0 * c.groups + group;
  const bool lead = !kWarp || (threadIdx.x & 31) == 0;
  if constexpr (kWarp) __syncwarp();
  int oh = 0, ot = 0;
  if (lead) {
    __threadfence();  // release: this tile's partials before its count
    if (h.on) oh = atomicAdd(ch, 1);
    if (tl.on) ot = atomicAdd(ct, 1);
  }
  if constexpr (kWarp) {
    oh = __shfl_sync(kFull, oh, 0);
    ot = __shfl_sync(kFull, ot, 0);
  }
  const bool last_h = h.on && oh == (int)(h.t1 - h.t0);
  const bool last_t = tl.on && ot == (int)(tl.t1 - tl.t0);
  if (!last_h && !last_t) return;
  if (lead) {
    if (last_h) *ch = 0;
    if (last_t) *ct = 0;
    __threadfence();  // acquire: the other tiles' partials after the count
  }
  if constexpr (kWarp) __syncwarp();
  if (last_h)
    chain_sum<NC>(c, tiles, h, c0, cstep, d.width(h.key), d.row(h.key),
                  d.add);
  if (last_t)
    chain_sum<NC>(c, tiles, tl, c0, cstep, d.width(tl.key), d.row(tl.key),
                  d.add);
}

}  // namespace ordered
