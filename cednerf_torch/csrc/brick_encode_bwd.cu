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
//   * the table gradient, in table_reduce_kernel<F> and the carry pass of
//     csrc/ordered_reduce.cuh: the keys sorted stably (csrc/key_sort.cuh,
//     exported below as key_sort: int32 keys and index), each
//     key's terms w_c * g are formed again from x and g and summed in sorted
//     order (ascending sample order within a key), each output row stored
//     once by one warp (the destinations are zero there). No float
//     atomics.
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
// The reduce. One warp walks a tile of `tile` sorted entries, 32 at a time:
// each lane first takes one entry (its sample's x and g, its level's
// geometry, its 8 corner weights), leaves them in shared memory, then the
// warp adds the 32 entries in order, one lane a (corner, feature): at F = 4
// the 8 x 4 lanes of an entry are the warp. The run's row of 64F lanes is
// held in shared memory (1 KB at F = 4); only the current run's row, not a
// level's gradient (level 0's alone is 216 x 256 x 4 B = 221 KB, a whole
// SM's shared memory). A __syncwarp after each entry orders the adds of
// two lanes to one corner.
//
// What bounds the backward: its needed bytes. x, g, rows and the table (or
// K2's gathered rows) read, d_table and d_x written once: 0.050 ms at N =
// 262,144, L8 F4 and 3.35 TB/s. This design adds the sort's keys (4 B a
// term written by the d_x kernel, 4 + 4 B of sorted key and index written
// by the sort and read by the reduce): 0.068 ms with them. On an H100
// 80GB HBM3 at 700 W (chip_smoke.py phases 3 and 18) K6 took 0.53 ms on
// uniform samples with torch.sort (0.165 of it, four 8-bit passes and a
// 64-bit index), this file's d_x kernel ~0.09 and reduce ~0.11 device-ms,
// the carry pass ~0.04. A form that added the terms with 16.8M float4 atomics
// took 0.448 ms there (bound by the atomics in the L2) and gave other bits
// on every run. The reduce stores a finished row: with a read-modify-write
// there it read 0.220 device-ms, with the store 0.110-0.148 (phase 18 of
// separate runs): the load sat on each warp's serial path.
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
// the reduce adds into it and fold_cells (below), which rounds and folds
// the cell rows as JAX's expansion transpose does, writes the zeros back
// as it reads them, so no call fills the 113 MB (2 x 16,384 rows x 27 x
// 128 B at the bench encoder's cell levels) and the brick table gradient
// is filled only on the brick levels.
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
// is (sample i, level l) with perm[p] = l*N + i. Destination: d.a the flat
// table gradient [n_table, 64F], d.b the cell rows [*, 8F] (K6c), each
// zero where a key lands (a key's row is stored); part [2, tiles, 64F] the
// tiles' partial rows for the carry pass. A term is w_c * g[f] in f32 (w_c = wx * (wy * wz), the plain
// version's order), or at a cell key the JAX cell levels' bf16 form
// bf16(bf16(bf16(wx * wy) * wz) * g[f]) of the bf16 axis weights.
constexpr int kReduceWarps = 4;

template <int F>
__global__ void __launch_bounds__(kReduceWarps * 32)
    table_reduce_kernel(const int* __restrict__ keys,
                        const int* __restrict__ perm,
                        long long n_entries, int tile,
                        const float* __restrict__ x,
                        const __nv_bfloat16* __restrict__ g, Levels lv,
                        int n_levels, long long n, ordered::Dest d,
                        float* __restrict__ part, long long tiles) {
  constexpr int W = 64 * F;
  __shared__ float s_acc[kReduceWarps][W];
  __shared__ float s_w[kReduceWarps][32][8];
  __shared__ float s_g[kReduceWarps][32][F];
  __shared__ int s_key[kReduceWarps][32];
  __shared__ int s_base[kReduceWarps][32];
  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kReduceWarps + wp;
  if (t >= tiles) return;  // a whole warp; the kernel has no block barrier
  const ordered::Tile tl = ordered::tile_of(keys, n_entries, t, tile);
  float* acc = s_acc[wp];
  for (int c = lane; c < W; c += 32) acc[c] = 0.0f;
  // lane = corner c * F + f of an entry's 8 corners (lanes >= 8F idle)
  const int cc = lane / F, ff = lane - (lane / F) * F;
  const bool term_lane = lane < 8 * F;
  int cur = __ldg(keys + tl.s);
  long long run_a = tl.s;
  // the run [a, b) of key k stored to its row or left as a partial (every
  // add before a flush is behind a __syncwarp)
  auto flush = [&](int k, long long a, long long b) {
    if (d.valid(k)) {
      const int target = ordered::run_target(tl, a, b, k);
      float* dst = target == 0 ? d.row(k)
                               : part + ((target - 1) * tiles + t) * W;
      const int w = d.width(k);
      for (int c = lane; c < w; c += 32) {
        dst[c] = acc[c];
        acc[c] = 0.0f;
      }
    }
    __syncwarp();
  };
  for (long long p0 = tl.s; p0 < tl.e; p0 += 32) {
    const long long p = p0 + lane;
    if (p < tl.e) {
      const int k = __ldg(keys + p);
      s_key[wp][lane] = k;
      if (d.valid(k)) {
        const long long j = __ldg(perm + p);
        const int l = (int)(j / n);
        const long long i = j - (long long)l * n;
        int ia[3];
        float w[3][2], ok[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          axis_geom(__ldg(x + i * 3 + a), lv.scale[l], lv.nb[l], ia[a],
                    w[a][1], w[a][0], ok[a]);
        const bool cell = k >= d.n_a;
        float wb[3][2];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          wb[a][1] = bf16r(w[a][1]);
          wb[a][0] = bf16r(1.0f - wb[a][1]);
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int kx = c >> 2, ky = (c >> 1) & 1, kz = c & 1;
          s_w[wp][lane][c] =
              cell ? bf16r(bf16r(wb[0][kx] * wb[1][ky]) * wb[2][kz])
                   : w[0][kx] * (w[1][ky] * w[2][kz]);
        }
#pragma unroll
        for (int f = 0; f < F; ++f)
          s_g[wp][lane][f] =
              __bfloat162float(g[i * (n_levels * F) + l * F + f]);
        s_base[wp][lane] = cell ? -1 : ia[0] * 16 + ia[1] * 4 + ia[2];
      }
    }
    __syncwarp();
    const int cnt = (int)min((long long)32, tl.e - p0);
    for (int q = 0; q < cnt; ++q) {
      const int k = s_key[wp][q];
      if (k != cur) {
        flush(cur, run_a, p0 + q);
        cur = k;
        run_a = p0 + q;
      }
      if (term_lane && d.valid(k)) {
        const int base = s_base[wp][q];
        float v = __fmul_rn(s_w[wp][q][cc], s_g[wp][q][ff]);
        int pos = lane;  // a cell row: lane d*F + f
        if (base >= 0)
          pos = (base + (cc >> 2) * 16 + ((cc >> 1) & 1) * 4 + (cc & 1)) * F +
                ff;
        else
          v = bf16r(v);
        acc[pos] = __fadd_rn(acc[pos], v);
      }
      __syncwarp();
    }
  }
  flush(cur, run_a, tl.e);
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

// The table-gradient reduce of K6, K6c and K2: keys [E] i32 sorted stably
// and perm [E] i32 (key_sort's indices into the [L, N] keys), x [N, 3] f32
// and g [N, L*F] bf16 as given to the first part -> d_table [n_table, 64F]
// f32 and d_cell [n_cell, 8F] f32 (n_cell 0: none), zero on entry where a
// key lands (each key's row is stored once); part
// [2, ceil(E / tile), 64F] f32 scratch, whose partial rows
// brick_table_carry then adds. Returns cudaGetLastError().
int brick_table_reduce(const int* keys, const int* perm,
                       long long n_entries, int tile, const float* x,
                       const void* g, int n_levels, long long n, int n_feat,
                       const float* scales, const int* nbs,
                       float* d_table, long long n_table, float* d_cell,
                       long long n_cell, float* part, void* stream) {
  Levels lv;
  if (n <= 0 || tile <= 0 || n_entries != n * n_levels ||
      !bwd_args_ok(lv, n, n_levels, n_feat, scales, nbs, nullptr, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n_entries + tile - 1) / tile;
  const unsigned int grid =
      (unsigned int)((tiles + kReduceWarps - 1) / kReduceWarps);
  const ordered::Dest d = table_dest(d_table, n_table, d_cell, n_cell,
                                     n_feat);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
  switch (n_feat) {
    case 1:
      table_reduce_kernel<1><<<grid, kReduceWarps * 32, 0, st>>>(
          keys, perm, n_entries, tile, x, gb, lv, n_levels, n, d, part,
          tiles);
      break;
    case 2:
      table_reduce_kernel<2><<<grid, kReduceWarps * 32, 0, st>>>(
          keys, perm, n_entries, tile, x, gb, lv, n_levels, n, d, part,
          tiles);
      break;
    default:
      table_reduce_kernel<4><<<grid, kReduceWarps * 32, 0, st>>>(
          keys, perm, n_entries, tile, x, gb, lv, n_levels, n, d, part,
          tiles);
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

// The carry pass after brick_table_reduce, on the same keys, part and
// destinations. Returns cudaGetLastError().
int brick_table_carry(const int* keys, long long n_entries, int tile,
                      const float* part, float* d_table, long long n_table,
                      float* d_cell, long long n_cell, int n_feat,
                      void* stream) {
  if (n_entries <= 0 || tile <= 0 ||
      !(n_feat == 1 || n_feat == 2 || n_feat == 4))
    return static_cast<int>(cudaErrorInvalidValue);
  return ordered::launch_carry(keys, n_entries, tile, part,
                               (n_entries + tile - 1) / tile, 64 * n_feat,
                               table_dest(d_table, n_table, d_cell, n_cell,
                                          n_feat),
                               static_cast<cudaStream_t>(stream));
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
