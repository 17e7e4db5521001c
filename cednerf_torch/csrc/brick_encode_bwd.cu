// Brick-encoder backward kernels for Hopper (sm_90a), bound through ctypes by
// cednerf_torch/ops/encode_kernels.py, which also holds their plain PyTorch
// versions.
//
// What they replace:
//   K6 brick_fused_encode_bwd  <- cednerf_tpu/ops/pallas_fused.py::
//                                 _build_fused_bwd (public fused_encode_bwd):
//                                 the backward of K5, re-gathering the brick
//                                 rows from the table inside the kernel.
//   K2 brick_interp_bwd_fused  <- cednerf_tpu/ops/pallas_encoder.py::
//                                 _build_bwd_fused (public interp_bwd_fused):
//                                 the same given the gathered rows [L, N, 64F]
//                                 that the K1 forward saved.
//   K6c brick_fused_encode_bwd_cell
//                              <- the cell row layouts' table-gradient
//                                 scatter (cednerf_tpu/ops/brick_grid.py
//                                 `_scatter_rows` into [rows*27, 8F], which
//                                 reaches pallas_scatter.py::
//                                 scatter_add_rows under scatter_impl
//                                 "pallas"): K6 with a third accumulation
//                                 target, see the note above
//                                 encode_bwd_kernel.
//   fold_cells brick_fold_cells
//                              <- the backward of the cell layouts'
//                                 expansion (cednerf_tpu/ops/brick_grid.py
//                                 `_expand_cell_table`, an XLA dot there:
//                                 its transpose folds K6c's per-cell sums
//                                 onto the brick corners); see the note
//                                 above fold_cells_kernel.
//   K7 brick_interp_bwd        <- cednerf_tpu/ops/pallas_encoder.py::
//                                 _build_bwd (public interp_bwd): K1's
//                                 backward that writes every level's update
//                                 rows [L, N, 64F] for the caller to scatter
//                                 (K3) instead of accumulating them; see the
//                                 note above interp_bwd_rows_kernel.
//
// All three compute, for every (sample, level), the gradient of
//   out[i, l*F + f] = sum_c w_c(frac) * row[c*F + f]
// with respect to the brick row (d_table[row, c*F + f] += w_c * g[i, l*F+f])
// and to the position (d_x[i, a] += scale_l * ok_a * sum_c dw_c/dfrac_a *
// sum_f row[c*F+f] * g[i, l*F+f]). Only the 8 corners of the sample's cell
// carry weight; the TPU kernels build all 64F lanes and multiply 56 of them
// by zero, here a thread visits the 8 corners alone. Layout and geometry are
// K5's (csrc/brick_encode_fwd.cu): lane = corner*F + f, corner = dx*16 +
// dy*4 + dz, pos = x*scale + 0.5 rounded once.
//
// Rounding. Weights, products and sums are f32 (the JAX kernels form the
// lane weights and products in bf16 and sum in f32); g and the rows are the
// bf16 values the forward produced and read; the wrapper rounds the finished
// table gradient to bf16 once when the spec asks for a bf16 accumulator.
//
// Order. The backward gives the same bits on every run, as the TPU's does
// (one core walks the sample tiles in order there). It is two parts:
//   * d_x, in encode_bwd_kernel<F, Rows, kCell>: each (sample, level) is one
//     thread, and the position gradient is summed over the levels in level
//     order in shared memory and written once per sample. The thread also
//     writes the key of its table-gradient terms: the row of the flat table
//     (offset_l + r) or, for K6c's cell levels, the cell row (see below), or
//     INT_MAX when its cotangent is all zero (an unused budget slot: its
//     loads are skipped and its terms dropped).
//   * the table gradient, in table_reduce_kernel<F>, the ordered reduce of
//     csrc/ordered_reduce.cuh with its carry folded in: the keys sorted
//     stably (csrc/key_sort.cuh, exported below as key_sort: int32 keys
//     and index), each key's terms w_c * g formed again from x and g and
//     summed in sorted order (ascending sample order within a key), each
//     output row stored once. The reduce writes every row of the table
//     gradient, zeros where no key lands, so the wrapper does not fill it.
//     No float atomics.
//
// K6 and K2 are one kernel, encode_bwd_kernel<F, Rows>, templated on where
// the brick row of a (sample, level) lies: row r of level l in the flat
// table (K6, Rows::kTable, re-gathered inside the kernel) or row (l, i) of
// the gathered rows [L, N, 64F] that the K1 forward saved (K2,
// Rows::kGathered). Nothing else differs, and the table-gradient terms do
// not depend on the rows at all, so one reduce serves both. A block of the
// d_x kernel is 32 consecutive samples x L levels with one warp per level,
// so the level's constants are warp-uniform; the thread reads the 4 z-lines
// of its cell through the read-only path (zline.cuh, as K5 and K1: 128 B at
// F = 4, not 8 separate corners).
//
// The reduce. One warp walks a tile of `tile` sorted entries, 32 at a
// time: each lane takes one entry (its sample's x and g, its level's
// geometry) and the warp adds the 32 entries in order, the terms routed to
// their lanes by shuffles and summed in registers (see the note above
// table_reduce_kernel). Its earlier form kept the run's row in
// shared memory, one lane a (corner, feature) and a __syncwarp after each
// entry, loaded each batch's keys, perm, x and g before adding it and found
// the level by a 64-bit division: 0.183 device-ms on K6's 2.1 M uniform
// entries (L8 F4, N = 262,144) against its 0.041-ms byte bound, then a
// carry launch of 0.053, and the wrapper's zero fill of the table gradient
// before it, 0.027 (88,968 rows x 1 KB at the bench encoder). This form,
// its carry and the fill folded in: 0.191 device-ms, and K6 0.390 ms by
// events against the earlier form's 0.463 (an NVIDIA H100 80GB HBM3 at
// 700 W, chip_smoke.py --sort_ab in turns with the earlier form). It is
// bound by instruction issue, not bytes: an entry costs each lane 6
// shuffles and an 8-way predicated add, integer instructions first.
//
// What bounds the backward: its needed bytes. x, g, rows and the table (or
// K2's gathered rows) read, d_table and d_x written once: 0.050 ms at N =
// 262,144, L8 F4 and 3.35 TB/s. This design adds the sort's keys (4 B a
// term written by the d_x kernel, 4 + 4 B of sorted key and index written
// by the sort and read by the reduce): 0.068 ms with them. A form that
// added the terms with 16.8M float4 atomics took 0.448 ms there (bound by
// the atomics in the L2, an NVIDIA H100 80GB HBM3 at 700 W) and gave other
// bits on every run.
//
// What bounds K2 beyond K6: its rows are read once and never by another
// thread, so the z-lines come from HBM, not from a table mostly held in the
// L2: N*L*4*8F bytes, 268 MB at N = 262,144 L8 F4, ~0.08 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "key_sort.cuh"
#include "ordered_reduce.cuh"
#include "zline.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kBlock = 128;

struct Levels {
  float scale[kMaxLevels];
  int nb[kMaxLevels];            // bricks per axis
  int rows[kMaxLevels];          // table rows of the level (row indices are
                                 // clamped to it, as in the plain version)
  long long offset[kMaxLevels];  // first row of the level in the flat table
  long long cell[kMaxLevels];    // K6c: first row of the level in the cell
                                 // gradient [sum 27 R_l, 8F], -1 for a
                                 // level that keeps the brick target
};

// Cell geometry of one axis, bit-identical to K5's axis_geom and to the
// plain version's cell_geom, plus the edge gate: ok = 0 where the cell was
// clamped into [0, 3*nb - 1].
__device__ __forceinline__ void axis_geom(float xa, float scale, int nb,
                                          int& intra, float& frac,
                                          float& one_minus, float& ok) {
  const float pos = __double2float_rn(
      __dadd_rn(__dmul_rn((double)xa, (double)scale), 0.5));
  const float pg = floorf(pos);
  frac = __fsub_rn(pos, pg);
  one_minus = __fsub_rn(1.0f, frac);
  const int hi = nb * 3 - 1;
  ok = (pg >= 0.0f && pg <= (float)hi) ? 1.0f : 0.0f;
  int cell = (int)fminf(fmaxf(pg, -1.0f), (float)(hi + 1));
  cell = min(max(cell, 0), hi);
  intra = cell - (cell / 3) * 3;
}

// v rounded to bf16 (nearest even) and back.
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int F>
__device__ __forceinline__ void load_corner(const __nv_bfloat16* p,
                                            float (&v)[F]) {
  if constexpr (F == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else if constexpr (F == 2) {
    const float2 a = __bfloat1622float2(
        __ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

constexpr int kBwdSamples = 32;  // samples of a d_x block: a warp a level
constexpr int kNoKey = 0x7fffffff;  // a (sample, level) with zero cotangent

// Where the brick row of (sample i, level l) lies: row offset_l + r of the
// flat table [sum R_l, 64F] (K6) or row l*N + i of the gathered rows
// [L, N, 64F] (K2).
enum class Rows { kTable, kGathered };

// K6c, the cell row layouts' backward (kCell): the JAX package's cell
// levels accumulate the table gradient per (brick row, cell) into an f32
// [rows*27, 8F] buffer, lane d*F + f with d = dx*4 + dy*2 + dz, which it
// rounds to the compute dtype before folding it onto the brick corners
// (ops/brick_grid.py `_make_level_encode_cell`), each term w * g formed
// in bf16 as the compute dtype makes it there. So a level whose
// lv.cell[l] >= 0 keys its terms to the cell row lv.cell[l] + r*27 + cell
// of d_cell (after the n_table rows of d_table in the reduce's key space)
// in place of brick row r of d_table, and the reduce sums them into that
// 8F-lane row (8 consecutive corners, one 128-byte line at F = 4). Levels
// with lv.cell[l] < 0 keep K6's brick target in the same launch. d_cell is
// a buffer that the wrapper keeps resident and all zero between calls:
// the reduce stores a key's row into it and fold_cells (below), which
// rounds and folds the cell rows as JAX's expansion transpose does, writes
// the zeros back as it reads them, so no call fills the 113 MB (2 x 16,384
// rows x 27 x 128 B at the bench encoder's cell levels). The table
// gradient is not filled either: the reduce writes the brick levels' rows
// (zeros where no key lands) and fold_cells the cell levels'.
//
// The d_x kernel: x [N, 3] f32, g [N, L*F] bf16, rows [L, N] i32
// (level-local), src the table or the gathered rows (bf16) -> d_x [N, 3]
// (written) and keys [L, N] i32 (written).
// Block (32, L): threadIdx.x is the sample, threadIdx.y the level.
template <int F, Rows kRows, bool kCell>
__global__ void __launch_bounds__(kBwdSamples * kMaxLevels)
    encode_bwd_kernel(const float* __restrict__ x,
                      const __nv_bfloat16* __restrict__ g,
                      const int* __restrict__ rows,
                      const __nv_bfloat16* __restrict__ src, Levels lv,
                      int n_levels, long long n, long long n_table,
                      int* __restrict__ keys, float* __restrict__ d_x) {
  constexpr int W = 64 * F;
  __shared__ float s_dx[kMaxLevels][3][kBwdSamples];
  const int lane = threadIdx.x;
  const int l = threadIdx.y;
  const long long i = (long long)blockIdx.x * kBwdSamples + lane;
  const bool valid = i < n;
  float gf[F];
  bool any = false;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    gf[f] = valid ? __bfloat162float(g[i * (n_levels * F) + l * F + f])
                  : 0.0f;
    any |= gf[f] != 0.0f;
  }
  float dxl[3] = {0.0f, 0.0f, 0.0f};
  int key = kNoKey;
  if (any) {  // else every term of this (sample, level) is zero
    const float scale = lv.scale[l];
    int r = __ldg(rows + (long long)l * n + i);
    r = min(max(r, 0), lv.rows[l] - 1);
    const float p[3] = {__ldg(x + i * 3), __ldg(x + i * 3 + 1),
                        __ldg(x + i * 3 + 2)};
    int ia[3];
    float w[3][2], ok[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      axis_geom(p[a], scale, lv.nb[l], ia[a], w[a][1], w[a][0], ok[a]);
    const __nv_bfloat16* row =
        src + (kRows == Rows::kTable ? lv.offset[l] + r
                                     : (long long)l * n + i) * W;
    ZLine<F> line[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      line[q] = load_zline<F>(
          row + ((ia[0] + (q >> 1)) * 16 + (ia[1] + (q & 1)) * 4) * F);
    float s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kx = q >> 1, ky = q & 1;
      // h_k = sum_f row[corner k of the line, f] * g[f]
      float hk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        hk[k] = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f)
          hk[k] = fmaf(zval<F>(line[q], k, f), gf[f], hk[k]);
      }
#pragma unroll
      for (int kz = 0; kz < 2; ++kz) {
        const int k = ia[2] + kz;
        const float h =
            k == 0 ? hk[0] : (k == 1 ? hk[1] : (k == 2 ? hk[2] : hk[3]));
        const float wyz = w[1][ky] * w[2][kz];
        // d w_c / d frac_a = +-(product of the other two axes' weights)
        s[0] += (kx ? h : -h) * wyz;
        s[1] += (ky ? h : -h) * (w[0][kx] * w[2][kz]);
        s[2] += (kz ? h : -h) * (w[0][kx] * w[1][ky]);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) dxl[a] = s[a] * ok[a] * scale;
    key = kCell && lv.cell[l] >= 0
              ? (int)(n_table + lv.cell[l] + (long long)r * 27 +
                      (ia[0] * 9 + ia[1] * 3 + ia[2]))
              : (int)(lv.offset[l] + r);
  }
  if (valid) keys[(long long)l * n + i] = key;
#pragma unroll
  for (int a = 0; a < 3; ++a) s_dx[l][a][lane] = dxl[a];
  __syncthreads();
  if (l == 0 && valid) {
    float dx[3] = {0.0f, 0.0f, 0.0f};
    for (int m = 0; m < n_levels; ++m) {
#pragma unroll
      for (int a = 0; a < 3; ++a) dx[a] += s_dx[m][a][lane];
    }
    d_x[i * 3] = dx[0];
    d_x[i * 3 + 1] = dx[1];
    d_x[i * 3 + 2] = dx[2];
  }
}

// The table-gradient reduce of K6, K6c and K2 (see the notes at the top and
// in csrc/ordered_reduce.cuh). keys [E] i32 sorted, perm [E] i32: entry p
// is (sample i, level l) with perm[p] = l*N + i, and l follows from the key
// (level l's keys lie in its rows, a cell level's in its cell rows: a few
// compares against lv, no division). Destination: d.a the flat table
// gradient [n_table, 64F], d.b the cell rows [*, 8F] (K6c), each key's row
// stored; c.part [2, tiles, 64F] the crossing runs' partial rows. A term is
// w_c * g[f] in f32 (w_c = wx * (wy * wz), the plain version's order), or
// at a cell key the JAX cell levels' bf16 form bf16(bf16(bf16(wx * wy) *
// wz) * g[f]) of the bf16 axis weights.
//
// One warp a tile of `tile` sorted entries, walked in batches of 32. Lane
// q loads entry q of a batch (its key and perm from a ring of kStage
// batches that cp.async keeps in flight, copied by the lane that reads
// them, so no barrier publishes them; then x and g, issued a batch ahead
// of the adds), finds its geometry and hands it to the warp by shuffles:
// an info word (each lane's corner slot, the intra-cell bits, valid, cell
// and new-run flags), the three fractions and g. The run's row is held in
// registers: lane p*F + f owns the 8 corners of parity p = (x&1, y&1, z&1)
// at feature f (acc[s], s = (x>>1, y>>1, z>>1)); an entry's 8 corners have
// the 8 parities, so each term lane adds one term an entry, into its own
// register, in sorted order. A cell row's 8F lanes are lane d*F + f, acc[0].
// No shared-memory read-modify-write and no barrier between two entries.
//
// Every row of d.a inside sp's spans is written once: a key's row by its
// run (or by the folded carry), every other row with zeros. The gap after
// key k up to the next key k2 belongs to the tile where k's run ends; it
// writes the gap's rows that lie in the kZeroChunk-row chunks of k and of
// k2. A chunk that holds no key is written by a zero warp (the warps after
// the tiles': one a chunk, which finds that it holds no key by one search
// of the keys), so a wide gap (samples in one brick leave most of the table
// untouched) is spread over many warps.
constexpr int kReduceWarps = 4;
constexpr int kStage = 8;        // batches of keys and perm in flight a warp
constexpr int kZeroChunk = 128;  // rows of d.a a zero warp takes
constexpr unsigned kInfoValid = 1u << 27, kInfoCell = 1u << 28,
                   kInfoNewRun = 1u << 29;
// The info bits 3p + 2 - a of the parities p whose bit on axis a
// (p >> (2 - a) & 1) is v.
__host__ __device__ constexpr unsigned slot_bits(int a, int v) {
  unsigned m = 0;
  for (int p = 0; p < 8; ++p)
    if (((p >> (2 - a)) & 1) == v) m |= 1u << (3 * p + 2 - a);
  return m;
}

// Rows [lo, hi) of d.a that the reduce writes (the brick levels'; K6c's
// cell levels' rows are fold_cells'), n spans.
struct Spans {
  int n;
  long long lo[kMaxLevels], hi[kMaxLevels];
};

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStage - 1) : "memory");
}

// Zeros into rows [a, b) of d.a within the spans, by one warp.
__device__ __forceinline__ void zero_rows(const ordered::Dest& d,
                                          const Spans& sp, long long a,
                                          long long b, int lane) {
  for (int s = 0; s < sp.n; ++s) {
    const long long lo = max(a, sp.lo[s]), hi = min(b, sp.hi[s]);
    if (lo >= hi) continue;
    float4* p = reinterpret_cast<float4*>(d.a + lo * d.w_a);
    const long long n4 = (hi - lo) * d.w_a / 4;
    for (long long u = lane; u < n4; u += 32)
      p[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// The gap after key k (0 <= k < n_a) up to k2 (the next key, or anything
// >= n_a when no row of d.a follows): its rows in k's chunk and, when k2 is
// a row of d.a, in k2's.
__device__ __forceinline__ void zero_gap(const ordered::Dest& d,
                                         const Spans& sp, long long k,
                                         long long k2, int lane) {
  const long long hi = min(k2, d.n_a);
  const long long ce = (k / kZeroChunk + 1) * kZeroChunk;
  zero_rows(d, sp, k + 1, min(ce, hi), lane);
  if (k2 < d.n_a) zero_rows(d, sp, max(k2 / kZeroChunk * kZeroChunk, ce), k2,
                            lane);
}

// The first p in [0, n) with keys[p] >= v (n if none), by the warp: each
// round its 32 lanes probe 32 points of the range, so ~log32(n) rounds.
__device__ __forceinline__ long long warp_lower_bound(const int* keys,
                                                      long long n,
                                                      long long v, int lane) {
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi > lo) {
    const long long len = hi - lo;
    const bool below = __ldg(keys + lo + len * lane / 32) < v;
    const int c = __popc(__ballot_sync(ordered::kFull, below));
    if (c == 0) {
      hi = lo;
    } else {
      const long long a = lo + len * (c - 1) / 32;
      hi = c < 32 ? lo + len * c / 32 : hi;
      lo = a + 1;
    }
  }
  return lo;
}

// Zero warp z: rows [z*C, (z+1)*C) of d.a, zeroed if no key lands in them.
__device__ __forceinline__ void zero_chunk(const int* keys, long long n_entries,
                                           const ordered::Dest& d,
                                           const Spans& sp, long long z,
                                           int lane) {
  const long long lo = z * kZeroChunk, hi = min(lo + kZeroChunk, d.n_a);
  const long long p = warp_lower_bound(keys, n_entries, lo, lane);
  if (p < n_entries && __ldg(keys + p) < hi) return;
  zero_rows(d, sp, lo, hi, lane);
}

// The level of a valid key: the last level whose first row (flat table)
// or first cell row (past n_table) it reaches.
__device__ __forceinline__ int level_of(const Levels& lv, int n_levels, int k,
                                        long long n_table) {
  int l = 0;
  if (k < n_table) {
#pragma unroll
    for (int m = 1; m < kMaxLevels; ++m)
      if (m < n_levels && k >= lv.offset[m]) l = m;
  } else {
    const long long kc = k - n_table;
#pragma unroll
    for (int m = 0; m < kMaxLevels; ++m)
      if (m < n_levels && lv.cell[m] >= 0 && kc >= lv.cell[m]) l = m;
  }
  return l;
}

// One entry as its lane loads it: key, level, x and g's F bf16 values.
template <int F>
struct Entry {
  int key;
  bool live;  // a key of the destination, inside the tile: loads issued
  int l;
  float x[3];
  unsigned gw[(F + 1) / 2];
};

template <int F>
__global__ void __launch_bounds__(kReduceWarps * 32)
    table_reduce_kernel(const int* __restrict__ keys,
                        const int* __restrict__ perm,
                        long long n_entries, int tile,
                        const float* __restrict__ x,
                        const __nv_bfloat16* __restrict__ g, Levels lv,
                        int n_levels, long long n, ordered::Dest d,
                        ordered::Carry c, long long tiles, Spans sp,
                        long long zero_chunks) {
  constexpr int W = 64 * F;
  constexpr int kG = (F + 1) / 2;
  __shared__ int s_key[kReduceWarps][kStage][32];
  __shared__ int s_perm[kReduceWarps][kStage][32];
  __shared__ ordered::Runs s_runs[kReduceWarps];
  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kReduceWarps + wp;
  if (t >= tiles) {  // a whole warp; the kernel has no block barrier
    if (t - tiles < zero_chunks) zero_chunk(keys, n_entries, d, sp,
                                            t - tiles, lane);
    return;
  }
  const ordered::Tile tl = ordered::tile_of(keys, n_entries, t, tile);
  {  // the tile's crossing runs, their keys' loads in flight together; kept
     // in shared memory (not registers) until the fold
    const ordered::Runs runs =
        ordered::crossing_runs(keys, tl, t, tile, tiles, d);
    if (lane == 0) s_runs[wp] = runs;
  }
  const int batches = (int)((tl.e - tl.s + 31) / 32);
  // batch b's key and perm of this lane into ring slot b % kStage
  auto stage = [&](int b) {
    const long long p = tl.s + (long long)b * 32 + lane;
    if (b < batches && p < tl.e) {
      cp_async4(&s_key[wp][b % kStage][lane], keys + p);
      cp_async4(&s_perm[wp][b % kStage][lane], perm + p);
    }
    cp_async_commit();
  };
  for (int b = 0; b < kStage; ++b) stage(b);
  // batch b's entry of this lane, its loads issued; the slot refilled
  auto load = [&](int b) {
    Entry<F> e;
    const long long p = tl.s + (long long)b * 32 + lane;
    cp_async_wait_stage();
    e.key = p < tl.e ? s_key[wp][b % kStage][lane] : kNoKey;
    const int j = s_perm[wp][b % kStage][lane];
    e.live = p < tl.e && d.valid(e.key);
    e.l = 0;
    if (e.live) {
      e.l = level_of(lv, n_levels, e.key, d.n_a);
      const long long i = j - (long long)e.l * n;
      e.live = i >= 0 && i < n;  // a key outside its level's rows: dropped
      if (e.live) {
#pragma unroll
        for (int a = 0; a < 3; ++a) e.x[a] = __ldg(x + i * 3 + a);
        const __nv_bfloat16* gp = g + i * (n_levels * F) + e.l * F;
        if constexpr (F == 4) {
          const uint2 q = __ldg(reinterpret_cast<const uint2*>(gp));
          e.gw[0] = q.x;
          e.gw[kG - 1] = q.y;
        } else if constexpr (F == 2) {
          e.gw[0] = __ldg(reinterpret_cast<const unsigned*>(gp));
        } else {
          e.gw[0] = __ldg(reinterpret_cast<const unsigned short*>(gp));
        }
      }
    }
    stage(b + kStage);  // after the slot's values were used
    return e;
  };
  const bool term = F == 4 || lane < 8 * F;  // lanes with a term an entry
  const int par = lane / F, ff = lane - (lane / F) * F;  // parity, feature
  // g's bf16 of feature ff (byte pair ff & 1 of its word) into the high
  // half, zeros below; the parity's bits where the info word keeps an
  // entry's intra-cell bits
  const unsigned g_perm = (ff & 1) ? 0x3244u : 0x1044u;
  const unsigned par_bits = (unsigned)(par & 7) << 24;
  float acc[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) acc[s] = 0.0f;
  int cur = __ldg(keys + tl.s);
  long long run_a = tl.s;
  if (t == 0 && sp.n > 0 && cur < d.n_a)  // the rows before the first key
    zero_rows(d, sp, cur / kZeroChunk * kZeroChunk, cur, lane);
  // the run [a, b) of key k stored to its row or left as a partial, then
  // the gap after it when it ends here (next: the key after it)
  auto flush = [&](int k, long long a, long long b, long long next) {
    if (d.valid(k)) {
      const int target = ordered::run_target(tl, a, b, k);
      float* dst = target == 0 ? d.row(k)
                               : c.part + ((target - 1) * tiles + t) * W;
      if (term) {
        if (k >= d.n_a) {
          dst[lane] = acc[0];
        } else {
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            const int corner = ((s >> 2) * 2 + (par >> 2)) * 16 +
                               (((s >> 1) & 1) * 2 + ((par >> 1) & 1)) * 4 +
                               (s & 1) * 2 + (par & 1);
            dst[corner * F + ff] = acc[s];
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[s] = 0.0f;
    const bool ends = b < tl.e || !(tl.has_next && tl.next == k);
    if (sp.n > 0 && ends && k < d.n_a && next > k + 1)
      zero_gap(d, sp, k, next, lane);
  };
  Entry<F> e = load(0);
  int prev_last = cur;
  for (int b = 0; b < batches; ++b) {
    Entry<F> nx = e;
    if (b + 1 < batches) nx = load(b + 1);  // the next batch's loads fly
    const long long p0 = tl.s + (long long)b * 32;
    const int cnt = (int)min((long long)32, tl.e - p0);
    // this lane's entry for the warp: geometry, slots, flags
    unsigned info = 0;
    float fr[3] = {0.0f, 0.0f, 0.0f};
    if (e.live) {
      int ia[3];
      float om, ok;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        axis_geom(e.x[a], lv.scale[e.l], lv.nb[e.l], ia[a], fr[a], om, ok);
      info = kInfoValid;
      if (e.key >= d.n_a) {
        info |= kInfoCell;
      } else {
        // parity p's corner on axis a is bit (ia + (p_a ^ (ia & 1))) >> 1
        // of its slot: 0 for ia 0, 1 for ia 2, 1 - p_a for ia 1 (at bit
        // 3p + 2 - a of the info word)
#pragma unroll
        for (int a = 0; a < 3; ++a)
          info |= ia[a] == 2 ? slot_bits(a, 0) | slot_bits(a, 1)
                             : (ia[a] == 1 ? slot_bits(a, 0) : 0u);
        info |= (unsigned)((ia[0] & 1) * 4 + (ia[1] & 1) * 2 + (ia[2] & 1))
                << 24;
      }
    }
    int prev = __shfl_up_sync(ordered::kFull, e.key, 1);
    if (lane == 0) prev = prev_last;
    if (lane < cnt && e.key != prev) info |= kInfoNewRun;
    prev_last = __shfl_sync(ordered::kFull, e.key, 31);
    for (int q = 0; q < cnt; ++q) {
      const unsigned inf = __shfl_sync(ordered::kFull, info, q);
      float f3[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        f3[a] = __shfl_sync(ordered::kFull, fr[a], q);
      unsigned gq[kG];
#pragma unroll
      for (int u = 0; u < kG; ++u)
        gq[u] = __shfl_sync(ordered::kFull, e.gw[u], q);
      // g[ff] of the entry: its bf16 moved to the high half of a float
      const float gv = __uint_as_float(__byte_perm(
          F == 4 && ff >= 2 ? gq[kG - 1] : gq[0], 0u, g_perm));
      // this lane's corner of the entry relative to its cell, bit 26 - a
      // for axis a
      const unsigned rc = inf ^ par_bits;
      if ((inf & (kInfoNewRun | kInfoValid | kInfoCell)) != kInfoValid) {
        if (inf & kInfoNewRun) {
          const int k = __shfl_sync(ordered::kFull, e.key, q);
          flush(cur, run_a, p0 + q, k);
          cur = k;
          run_a = p0 + q;
        }
        if (term && (inf & kInfoCell)) {
          float wb[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float b1 = bf16r(f3[a]);
            wb[a] = rc & (1u << (26 - a)) ? b1 : bf16r(1.0f - b1);
          }
          acc[0] = __fadd_rn(acc[0], bf16r(__fmul_rn(
              bf16r(bf16r(wb[0] * wb[1]) * wb[2]), gv)));
          continue;
        }
        if (!(inf & kInfoValid)) continue;
      }
      if (term) {  // a brick key's term into this lane's slot of it
        float w[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          w[a] = rc & (1u << (26 - a)) ? f3[a] : __fsub_rn(1.0f, f3[a]);
        const float v = __fmul_rn(w[0] * (w[1] * w[2]), gv);
        const int slot = (int)(inf >> (3 * par)) & 7;
#pragma unroll
        for (int s = 0; s < 8; ++s)
          if (slot == s) acc[s] = __fadd_rn(acc[s], v);
      }
    }
    e = nx;
  }
  flush(cur, run_a, tl.e, tl.has_next ? (long long)tl.next : d.n_a);
  __syncwarp();  // lane 0's s_runs[wp] seen by every lane
  const ordered::Runs runs = s_runs[wp];
  ordered::fold_carry<2 * F, true>(runs, tiles, d, c, 0, lane, 32);
}

// K7. The same sums as K2, but the table-gradient terms are not added into a
// table: every (sample, level) gets its full update row upd[l, i, c*F + f] =
// (wx * (wy * wz)) * g[i, l*F + f], zero outside the cell's 8 corners, as
// the TPU kernel emits it for an XLA scatter-add.
//
// What bounds it on this card: the write of the rows. At N = 262,144, L8 F4
// they are 8 x 262,144 x 256 x 4 B = 2.15 GB of f32 (56 of every 64 corners
// zero), against 268 MB of corner reads and ~23 MB of x, g and d_x: ~0.73 ms
// at 3.35 TB/s. So a block takes kBlock samples and walks the levels. Per
// level, each thread first takes one sample: its geometry, its 8 corners
// (d_x summed in registers) and its 3 x 4 per-axis corner weights and
// F cotangents, which it leaves in shared memory. Then the block writes the
// level's kBlock rows, which are contiguous in [L, N, 64F], as 16-byte words
// in order: neighbouring threads write neighbouring words, with streaming
// stores (the rows are not read again here). A lane's value is rebuilt from
// shared memory in the plain version's order, so upd equals it bit for bit
// (up to the sign of a zero: 0 * a negative g is -0.0 on either side).
// bf16 rows are the f32 product rounded once.
template <int F, bool kBf16Out>
__global__ void __launch_bounds__(kBlock)
    interp_bwd_rows_kernel(const float* __restrict__ x,
                           const __nv_bfloat16* __restrict__ g,
                           const __nv_bfloat16* __restrict__ feats, Levels lv,
                           int n_levels, long long n, void* __restrict__ upd,
                           float* __restrict__ d_x) {
  constexpr int W = 64 * F;
  constexpr int kLanes = kBf16Out ? 8 : 4;   // lanes per 16-byte word
  constexpr int kWords = W / kLanes;         // words per row
  constexpr int kCorners = kLanes / F;       // corners per word
  __shared__ float s_w[3][4][kBlock];        // axis, corner k, sample
  __shared__ float s_g[F][kBlock];
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * kBlock;
  const int n_here = (int)min((long long)kBlock, n - i0);
  const long long i = i0 + t;
  const bool live = t < n_here;
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    p[0] = x[i * 3];
    p[1] = x[i * 3 + 1];
    p[2] = x[i * 3 + 2];
  }
  float dx[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < n_levels; ++l) {
    if (live) {
      int ia[3];
      float w[3][2], ok[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        axis_geom(p[a], lv.scale[l], lv.nb[l], ia[a], w[a][1], w[a][0], ok[a]);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          s_w[a][k][t] = k == ia[a] ? w[a][0] : (k == ia[a] + 1 ? w[a][1]
                                                                 : 0.0f);
      }
      float gf[F];
      bool any = false;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        gf[f] = __bfloat162float(g[i * (long long)(n_levels * F) + l * F + f]);
        s_g[f][t] = gf[f];
        any |= gf[f] != 0.0f;
      }
      if (any) {  // else every d_x term of this level is zero
        const __nv_bfloat16* row = feats + ((long long)l * n + i) * W;
        float s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) {
          const int kx = c8 >> 2, ky = (c8 >> 1) & 1, kz = c8 & 1;
          const int corner =
              (ia[0] + kx) * 16 + (ia[1] + ky) * 4 + (ia[2] + kz);
          float v[F];
          load_corner<F>(row + corner * F, v);
          float h = 0.0f;
#pragma unroll
          for (int f = 0; f < F; ++f) h = fmaf(v[f], gf[f], h);
          s[0] += (kx ? h : -h) * (w[1][ky] * w[2][kz]);
          s[1] += (ky ? h : -h) * (w[0][kx] * w[2][kz]);
          s[2] += (kz ? h : -h) * (w[0][kx] * w[1][ky]);
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) dx[a] += s[a] * ok[a] * lv.scale[l];
      }
    }
    __syncthreads();
    // this level's rows of samples i0 .. i0 + n_here - 1, word by word
    const long long first = ((long long)l * n + i0) * kWords;
    for (int j = t; j < n_here * kWords; j += kBlock) {
      const int sm = j / kWords;
      const int c0 = (j - sm * kWords) * kCorners;
      float v[kLanes];
#pragma unroll
      for (int cc = 0; cc < kCorners; ++cc) {
        const int c = c0 + cc;
        const float wc = s_w[0][c >> 4][sm] *
                         (s_w[1][(c >> 2) & 3][sm] * s_w[2][c & 3][sm]);
#pragma unroll
        for (int f = 0; f < F; ++f) v[cc * F + f] = wc * s_g[f][sm];
      }
      if constexpr (kBf16Out) {
        uint4 q;
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          h2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        __stcs(static_cast<uint4*>(upd) + first + j, q);
      } else {
        __stcs(static_cast<float4*>(upd) + first + j,
               make_float4(v[0], v[1], v[2], v[3]));
      }
    }
    __syncthreads();
  }
  if (live) {
    d_x[i * 3] = dx[0];
    d_x[i * 3 + 1] = dx[1];
    d_x[i * 3 + 2] = dx[2];
  }
}

// fold_cells. The backward of the JAX cell layouts' expansion: brick row b
// of a cell level owns the 27 cell rows [b*27, b*27 + 27) of the per-cell
// gradient, 8F f32 lanes each (lane d*F + f, d = dx*4 + dy*2 + dz), and
// brick corner (X, Y, Z) is replicated in slot d = (X-cx)*4 + (Y-cy)*2 +
// (Z-cz) of every cell (cx, cy, cz) with c_a in {A-1, A} ∩ [0, 2]: 1 to 8
// slots. The kernel rounds each cell sum to the accumulator dtype (bf16
// when accum_bf16) and then to the compute dtype (bf16 when compute_bf16),
// as JAX casts the scatter's f32 result to its cell table's dtype; sums
// each corner's slots in f32 from 0, in ascending cell order (the order of
// brick_grid's fold index, which the plain version follows slot by slot,
// so the two agree bit for bit); rounds the sum to the compute dtype (the
// dot's result dtype) and writes it into the level's brick row of d_table
// as f32. As it reads the cell rows it writes zeros back over them: d_cell
// is the resident buffer that K6c (3D) or K3 (4D) adds into, all zero
// between calls.
//
// What bounds it: bytes. A brick row is read once (27 x 8F f32, 3.4 KB at
// F = 4, as coalesced float4 loads by the whole block), zeroed once and
// its 64F f32 lanes written once: at the bench encoder's two cell levels
// of 16,384 rows, 113 MB read + 113 MB zeroed + 33.5 MB written, ~0.078 ms
// at 3.35 TB/s. A block takes kFoldRows consecutive brick rows: it loads
// their cell rows into shared memory (27.6 KB at F = 4), every load issued
// before any store, then writes the zeros, then each thread forms output
// lanes from shared memory, neighbouring threads writing neighbouring
// lanes. All cell levels go in one launch (FoldLevels). On an H100 80GB
// HBM3 at 700 W (chip_smoke.py phase 15) it takes 0.099 ms there, against
// 0.68 ms for the torch.zeros fill and the plain tensor ops it replaced.
// Its first form stored each zero right after loading that float4 and took
// 0.42 ms: a thread's store to the address it has just loaded waits for
// that load, so each thread had one load in flight at a time. Skipping
// the brick rows K6c left untouched (a flag a row, set by K6c) was not
// taken: on a real train step's batch of the cell field (chip_smoke.py
// phase 15, train_cell_texture) K6c touches 39% and 74% of the two cell
// levels' rows, over half of them together, so at most ~40% of the
// fold's bytes could go, for a store a group in K6c.
constexpr int kFoldRows = 8;
constexpr int kFoldThreads = 256;

struct FoldLevels {
  int n;                              // cell levels of the launch
  long long first[kMaxLevels + 1];    // first brick row of level k in the
                                      // launch (first[n]: the total)
  long long cell[kMaxLevels];         // its first row in d_cell
  long long table[kMaxLevels];        // its first row in d_table
};

template <int F>
__global__ void __launch_bounds__(kFoldThreads)
    fold_cells_kernel(float* __restrict__ d_cell, float* __restrict__ d_table,
                      FoldLevels fl, int accum_bf16, int compute_bf16) {
  constexpr int kIn = 27 * 8 * F;   // f32 cell values of a brick row
  constexpr int kIn4 = kIn / 4;
  constexpr int kOut = 64 * F;      // f32 lanes of a brick row
  constexpr int kLoads = (kFoldRows * kIn4 + kFoldThreads - 1) / kFoldThreads;
  __shared__ float4 s_in[kFoldRows * kIn4];
  __shared__ long long s_src[kFoldRows], s_dst[kFoldRows];
  const long long b0 = (long long)blockIdx.x * kFoldRows;
  const int rows = (int)min((long long)kFoldRows, fl.first[fl.n] - b0);
  if ((int)threadIdx.x < rows) {
    const long long b = b0 + threadIdx.x;
    int k = 0;
    while (k + 1 < fl.n && b >= fl.first[k + 1]) ++k;
    s_src[threadIdx.x] = (fl.cell[k] + (b - fl.first[k]) * 27) * (8 * F);
    s_dst[threadIdx.x] = (fl.table[k] + (b - fl.first[k])) * kOut;
  }
  __syncthreads();
  // every load of the block is issued before any store to d_cell (see the
  // note above)
  float4 v[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int j = threadIdx.x + u * kFoldThreads;
    if (j < rows * kIn4) {
      const int r = j / kIn4;
      v[u] = reinterpret_cast<const float4*>(d_cell + s_src[r])[j - r * kIn4];
    }
  }
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int j = threadIdx.x + u * kFoldThreads;
    if (j < rows * kIn4) {
      if (accum_bf16) {
        v[u].x = bf16r(v[u].x); v[u].y = bf16r(v[u].y);
        v[u].z = bf16r(v[u].z); v[u].w = bf16r(v[u].w);
      }
      if (compute_bf16) {
        v[u].x = bf16r(v[u].x); v[u].y = bf16r(v[u].y);
        v[u].z = bf16r(v[u].z); v[u].w = bf16r(v[u].w);
      }
      s_in[j] = v[u];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < rows * kIn4; j += kFoldThreads) {
    const int r = j / kIn4;
    reinterpret_cast<float4*>(d_cell + s_src[r])[j - r * kIn4] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int j = threadIdx.x; j < rows * kOut; j += kFoldThreads) {
    const int r = j / kOut;
    const int lane = j - r * kOut;
    const int c = lane / F, f = lane - c * F;
    const int X = c >> 4, Y = (c >> 2) & 3, Z = c & 3;
    const float* s = reinterpret_cast<const float*>(s_in) + r * kIn;
    float acc = 0.0f;
    for (int cx = max(X - 1, 0); cx <= min(X, 2); ++cx)
      for (int cy = max(Y - 1, 0); cy <= min(Y, 2); ++cy)
        for (int cz = max(Z - 1, 0); cz <= min(Z, 2); ++cz) {
          const int d = (X - cx) * 4 + (Y - cy) * 2 + (Z - cz);
          acc = __fadd_rn(acc, s[((cx * 9 + cy * 3 + cz) * 8 + d) * F + f]);
        }
    d_table[s_dst[r] + lane] = compute_bf16 ? bf16r(acc) : acc;
  }
}

bool fill_levels(Levels& lv, int n_levels, const float* scales, const int* nbs,
                 const int* level_rows, const long long* cell_rows = nullptr) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  long long off = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.scale[l] = scales[l];
    lv.nb[l] = nbs[l];
    lv.rows[l] = level_rows ? level_rows[l] : 0;
    lv.offset[l] = off;
    lv.cell[l] = cell_rows ? cell_rows[l] : -1;
    off += lv.rows[l];
  }
  return true;
}

template <int F>
void launch_rows(unsigned grid, cudaStream_t st, const float* x,
                 const __nv_bfloat16* g, const __nv_bfloat16* feats,
                 const Levels& lv, int n_levels, long long n, void* upd,
                 int upd_bf16, float* d_x) {
  if (upd_bf16)
    interp_bwd_rows_kernel<F, true><<<grid, kBlock, 0, st>>>(
        x, g, feats, lv, n_levels, n, upd, d_x);
  else
    interp_bwd_rows_kernel<F, false><<<grid, kBlock, 0, st>>>(
        x, g, feats, lv, n_levels, n, upd, d_x);
}

bool bwd_args_ok(Levels& lv, long long n, int n_levels, int n_feat,
                 const float* scales, const int* nbs, const int* level_rows,
                 const long long* cell_rows) {
  return n > 0 && (n_feat == 1 || n_feat == 2 || n_feat == 4) &&
         fill_levels(lv, n_levels, scales, nbs, level_rows, cell_rows);
}

template <Rows kRows, bool kCell = false>
int launch_bwd(const float* x, const void* g, const int* rows,
               const void* src, int n_levels, long long n, int n_feat,
               const float* scales, const int* nbs, const int* level_rows,
               long long n_table, int* keys, float* d_x, void* stream,
               const long long* cell_rows = nullptr) {
  Levels lv;
  if (!bwd_args_ok(lv, n, n_levels, n_feat, scales, nbs, level_rows,
                   cell_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid =
      (unsigned int)((n + kBwdSamples - 1) / kBwdSamples);
  const dim3 block(kBwdSamples, n_levels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
  const __nv_bfloat16* sb = static_cast<const __nv_bfloat16*>(src);
  switch (n_feat) {
    case 1:
      encode_bwd_kernel<1, kRows, kCell><<<grid, block, 0, st>>>(
          x, gb, rows, sb, lv, n_levels, n, n_table, keys, d_x);
      break;
    case 2:
      encode_bwd_kernel<2, kRows, kCell><<<grid, block, 0, st>>>(
          x, gb, rows, sb, lv, n_levels, n, n_table, keys, d_x);
      break;
    default:
      encode_bwd_kernel<4, kRows, kCell><<<grid, block, 0, st>>>(
          x, gb, rows, sb, lv, n_levels, n, n_table, keys, d_x);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

ordered::Dest table_dest(float* d_table, long long n_table, float* d_cell,
                         long long n_cell, int n_feat) {
  return ordered::Dest{d_table, n_table, 64 * n_feat,
                       d_cell,  n_cell,  8 * n_feat, false};
}

}  // namespace

extern "C" {

const char* cednerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K6's first part. x [N,3] f32, g [N, L*F] bf16, rows [L, N] i32
// (level-local), table [sum R_l, 64F] bf16 -> d_x [N, 3] f32 and keys
// [L, N] i32 (offset_l + r, INT_MAX for a zero cotangent) for
// brick_table_reduce. Returns cudaGetLastError().
int brick_fused_encode_bwd(const float* x, const void* g, const int* rows,
                           const void* table, int n_levels, long long n,
                           int n_feat, const float* scales, const int* nbs,
                           const int* level_rows, long long n_table,
                           int* keys, float* d_x, void* stream) {
  return launch_bwd<Rows::kTable>(x, g, rows, table, n_levels, n, n_feat,
                                  scales, nbs, level_rows, n_table, keys, d_x,
                                  stream);
}

// K6c's first part. As K6, and cell_rows [L] i64: level l's first row in
// d_cell [sum 27 R_l, 8F], or -1 for a level whose gradient goes to d_table
// as in K6; a cell level's key is n_table + cell_rows[l] + r*27 + cell.
int brick_fused_encode_bwd_cell(const float* x, const void* g,
                                const int* rows, const void* table,
                                int n_levels, long long n, int n_feat,
                                const float* scales, const int* nbs,
                                const int* level_rows,
                                const long long* cell_rows, long long n_table,
                                int* keys, float* d_x, void* stream) {
  return launch_bwd<Rows::kTable, true>(x, g, rows, table, n_levels, n,
                                        n_feat, scales, nbs, level_rows,
                                        n_table, keys, d_x, stream,
                                        cell_rows);
}

// The table-gradient reduce of K6, K6c and K2, its carry folded in: keys
// [E] i32 sorted stably and perm [E] i32 (key_sort's indices into the
// [L, N] keys, each level's keys in its rows, level_rows [L], or its cell
// rows, cell_rows [L] i64 as K6c's, NULL for none), x [N, 3] f32 and g
// [N, L*F] bf16 as given to the first part -> d_table [n_table, 64F] f32,
// every row written (a key's sum, zeros elsewhere; with cell_rows, the
// cell levels' rows are left to fold_cells) and d_cell [n_cell, 8F] f32
// (n_cell 0: none), zero on entry where a key lands (its row is stored);
// part [2, ceil(E / tile), 64F] f32 scratch for the crossing runs' partial
// rows, count >= ceil(E / tile) int32 arrival counters, zero on entry and
// on return. Returns cudaGetLastError().
int brick_table_reduce(const int* keys, const int* perm,
                       long long n_entries, int tile, const float* x,
                       const void* g, int n_levels, long long n, int n_feat,
                       const float* scales, const int* nbs,
                       const int* level_rows, const long long* cell_rows,
                       float* d_table, long long n_table, float* d_cell,
                       long long n_cell, float* part, int* count,
                       void* stream) {
  Levels lv;
  if (n <= 0 || tile <= 0 || n_entries != n * n_levels ||
      !bwd_args_ok(lv, n, n_levels, n_feat, scales, nbs, level_rows,
                   cell_rows) ||
      lv.offset[n_levels - 1] + lv.rows[n_levels - 1] != n_table)
    return static_cast<int>(cudaErrorInvalidValue);
  Spans sp;
  sp.n = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (lv.cell[l] >= 0 || lv.rows[l] <= 0) continue;
    if (sp.n > 0 && sp.hi[sp.n - 1] == lv.offset[l]) {
      sp.hi[sp.n - 1] += lv.rows[l];
    } else {
      sp.lo[sp.n] = lv.offset[l];
      sp.hi[sp.n] = lv.offset[l] + lv.rows[l];
      ++sp.n;
    }
  }
  const long long tiles = (n_entries + tile - 1) / tile;
  const long long zero_chunks =
      sp.n > 0 ? (n_table + kZeroChunk - 1) / kZeroChunk : 0;
  const unsigned int grid = (unsigned int)(
      (tiles + zero_chunks + kReduceWarps - 1) / kReduceWarps);
  const ordered::Dest d = table_dest(d_table, n_table, d_cell, n_cell,
                                     n_feat);
  const ordered::Carry c{part, 64 * n_feat, count, 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
  switch (n_feat) {
    case 1:
      table_reduce_kernel<1><<<grid, kReduceWarps * 32, 0, st>>>(
          keys, perm, n_entries, tile, x, gb, lv, n_levels, n, d, c, tiles,
          sp, zero_chunks);
      break;
    case 2:
      table_reduce_kernel<2><<<grid, kReduceWarps * 32, 0, st>>>(
          keys, perm, n_entries, tile, x, gb, lv, n_levels, n, d, c, tiles,
          sp, zero_chunks);
      break;
    default:
      table_reduce_kernel<4><<<grid, kReduceWarps * 32, 0, st>>>(
          keys, perm, n_entries, tile, x, gb, lv, n_levels, n, d, c, tiles,
          sp, zero_chunks);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The stable sort of csrc/key_sort.cuh (as in scatter_add_rows.cu): keys
// [m] i32 -> keys_out [m] i32 (sorted; outside [0, n_keys) as n_keys,
// last) and perm [m] i32, with scratch of key_sort_scratch_words(m, n_keys)
// int32 words. Returns cudaGetLastError() after the launches.
int key_sort(const int* keys, long long m, int n_keys, int* keys_out,
             int* perm, int* scratch, void* stream) {
  return keysort::sort(keys, m, n_keys, keys_out, perm, scratch,
                       static_cast<cudaStream_t>(stream));
}

long long key_sort_scratch_words(long long m, int n_keys) {
  return keysort::scratch_words(m, n_keys);
}

// fold_cells. n_levels cell levels; level k has brick_rows[k] rows, its
// cell rows from row cell_rows[k] of d_cell [*, 8F] f32 (read, then
// zeroed) and its brick rows from row table_rows[k] of d_table [*, 64F]
// f32 (written). Returns cudaGetLastError().
int brick_fold_cells(float* d_cell, float* d_table, int n_levels,
                     const long long* brick_rows, const long long* cell_rows,
                     const long long* table_rows, int n_feat, int accum_bf16,
                     int compute_bf16, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels ||
      !(n_feat == 1 || n_feat == 2 || n_feat == 4))
    return static_cast<int>(cudaErrorInvalidValue);
  FoldLevels fl;
  fl.n = n_levels;
  fl.first[0] = 0;
  for (int k = 0; k < n_levels; ++k) {
    fl.first[k + 1] = fl.first[k] + brick_rows[k];
    fl.cell[k] = cell_rows[k];
    fl.table[k] = table_rows[k];
  }
  if (fl.first[n_levels] <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid =
      (unsigned int)((fl.first[n_levels] + kFoldRows - 1) / kFoldRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_feat) {
    case 1:
      fold_cells_kernel<1><<<grid, kFoldThreads, 0, st>>>(
          d_cell, d_table, fl, accum_bf16, compute_bf16);
      break;
    case 2:
      fold_cells_kernel<2><<<grid, kFoldThreads, 0, st>>>(
          d_cell, d_table, fl, accum_bf16, compute_bf16);
      break;
    default:
      fold_cells_kernel<4><<<grid, kFoldThreads, 0, st>>>(
          d_cell, d_table, fl, accum_bf16, compute_bf16);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// K2's first part. As K6 with feats [L, N, 64F] bf16 in place of the
// table; its keys go through brick_table_reduce as K6's do.
int brick_interp_bwd_fused(const float* x, const void* g, const int* rows,
                           const void* feats, int n_levels, long long n,
                           int n_feat, const float* scales, const int* nbs,
                           const int* level_rows, long long n_table,
                           int* keys, float* d_x, void* stream) {
  return launch_bwd<Rows::kGathered>(x, g, rows, feats, n_levels, n, n_feat,
                                     scales, nbs, level_rows, n_table, keys,
                                     d_x, stream);
}

// K7. x [N,3] f32, g [N, L*F] bf16, feats [L, N, 64F] bf16 -> upd
// [L, N, 64F] (upd_bf16: bf16, else f32; every lane written), d_x [N, 3]
// f32. Returns cudaGetLastError().
int brick_interp_bwd(const float* x, const void* g, const void* feats,
                     int n_levels, long long n, int n_feat, const float* scales,
                     const int* nbs, void* upd, int upd_bf16, float* d_x,
                     void* stream) {
  Levels lv;
  if (n <= 0 || !fill_levels(lv, n_levels, scales, nbs, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = (unsigned int)((n + kBlock - 1) / kBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
  const __nv_bfloat16* fb = static_cast<const __nv_bfloat16*>(feats);
  switch (n_feat) {
    case 1:
      launch_rows<1>(grid, st, x, gb, fb, lv, n_levels, n, upd, upd_bf16, d_x);
      break;
    case 2:
      launch_rows<2>(grid, st, x, gb, fb, lv, n_levels, n, upd, upd_bf16, d_x);
      break;
    case 4:
      launch_rows<4>(grid, st, x, gb, fb, lv, n_levels, n, upd, upd_bf16, d_x);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
