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
// bf16 values the forward produced and read. The table gradient is summed
// in f32 with atomicAdd, in an order that changes from run to run (on the
// TPU one core walks the sample tiles in order); the wrapper rounds the
// finished sum to bf16 once when the spec asks for a bf16 accumulator.
// d_x is summed over the levels in level order (K7 in registers, K6 and K2
// in shared memory) and written once per sample, so it is deterministic.
//
// K6 and K2 are one kernel, encode_bwd_kernel<F, Rows>, templated on where
// the brick row of a (sample, level) lies: row r of level l in the flat
// table (K6, Rows::kTable, re-gathered inside the kernel) or row (l, i) of
// the gathered rows [L, N, 64F] that the K1 forward saved (K2,
// Rows::kGathered). Nothing else differs. Each (sample, level) is one
// thread, and a block is 32 consecutive samples x L levels with one warp
// per level, so the level's constants are warp-uniform and 32 neighbouring
// samples of one level share a warp. The thread reads the 4 z-lines of its
// cell through the read-only path (zline.cuh, as K5 and K1: 128 B at F = 4,
// not 8 separate corners), computes the geometry once, forms the 8 corners'
// terms and adds each corner's F gradient lanes with one vector atomicAdd
// (float4 at F = 4, float2 at F = 2; sm_90, global memory): N*L*8 atomic
// operations, 16.8M at one train step's N = 262,144, L8 F4, instead of
// N*L*8*F scalar ones. Before the atomics, the lanes of a warp whose
// samples share a cell (a brick row and intra cell, hence all 8 corners)
// are found with __match_any_sync and their terms summed by shuffles, so
// that one lane adds each corner once: ray-major samples (a renderer's and
// the packed step's order) put 3-4 consecutive samples into one cell of the
// coarsest level. d_x: each thread leaves its level's 3 terms in shared
// memory, and the level-0 warp sums them over the levels in level order. A
// (sample, level) whose cotangent is all zero (an unused budget slot) skips
// its loads and atomics.
//
// What bounds K6: the atomics in the L2. Its needed bytes (table, x, g,
// rows read, d_table and d_x written once) take ~0.05 ms at 3.35 TB/s and
// its corner reads plus atomic payload ~0.16 ms; it takes ~0.45 ms on
// uniform random samples (16.8M float4 atomics, ~37 G/s) and ~0.30 ms on
// ray-major ones. Measured on an H100 80GB HBM3 at 700 W against an edited
// copy of this kernel without it, in one run: the match-group aggregation
// costs nothing on random samples (0.446 against 0.447 ms without it),
// saves a third on ray-major ones (0.296 against 0.437 ms) and 36% when
// every sample lies in one level-0 brick (0.548 against 0.859 ms).
// profile_training.py reports the share of atomics it saves on a real
// train step's batch (K2's with --interp).
// Accumulating the coarse levels in shared memory was not taken: level 0's
// f32 gradient alone is 216 x 256 x 4 B = 221 KB, a whole SM's shared
// memory for one block.
//
// What bounds K2: the same L2 atomics to the same addresses as K6, plus
// its z-lines. Its rows are read once and never by another thread, so the
// z-lines come from HBM, not from a table mostly held in the L2: N*L*4*8F
// bytes, 268 MB at N = 262,144 L8 F4, ~0.08 ms at 3.35 TB/s. On an H100
// 80GB HBM3 at 700 W, beside K6 in two chip_smoke.py runs of one call:
// 0.511-0.512 ms on uniform random samples against K6's 0.451-0.453, and
// 0.382-0.390 on ray-major ones against 0.297-0.299; there the lanes of a
// match group read one table row in K6, but each its own copy of that row
// in K2. On a real interp step's batch it takes 0.270 device-ms
// (profile_training.py --interp). Its first design (a thread per sample
// walking its levels, 8 separate corner reads and F scalar f32 atomics per
// corner) took 1.001-1.004 ms at N = 262,144 in the same call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// The F gradient lanes of one corner, added with one vector atomic.
template <int F>
__device__ __forceinline__ void add_corner(float* dst, const float (&v)[F]);
template <>
__device__ __forceinline__ void add_corner<4>(float* dst,
                                              const float (&v)[4]) {
  atomicAdd(reinterpret_cast<float4*>(dst),
            make_float4(v[0], v[1], v[2], v[3]));
}
template <>
__device__ __forceinline__ void add_corner<2>(float* dst,
                                              const float (&v)[2]) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
}
template <>
__device__ __forceinline__ void add_corner<1>(float* dst,
                                              const float (&v)[1]) {
  atomicAdd(dst, v[0]);
}

// kBytes of f32 in this thread's shared-memory slot src added into dst with
// one bulk reduction (sm_90). The fence makes the slot's generic-proxy
// stores visible to the async proxy; the wait keeps the slot alive until
// the copy engine has read it.
template <int kBytes>
__device__ __forceinline__ void bulk_add_row(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
      "[%1], %2;" ::"l"(dst),
      "r"(s), "r"(kBytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

constexpr int kBwdSamples = 32;  // samples of a K6/K2 block: a warp a level

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
// lv.cell[l] >= 0 adds its 8 corner terms into row lv.cell[l] + r*27 +
// cell of d_cell in place of brick row r of d_table: 8 consecutive
// corners of one 8F-lane row (one 128-byte line at F = 4), with the same
// match groups as K6, whose key r*27 + cell is exactly the cell row.
// Levels with lv.cell[l] < 0 keep K6's brick target in the same launch.
// d_cell is a buffer that the wrapper keeps resident and all zero between
// calls: K6c adds into it and fold_cells (below), which rounds and folds
// the cell rows as JAX's expansion transpose does, writes the zeros back
// as it reads them, so no call fills the 113 MB (2 x 16,384 rows x 27 x
// 128 B at the bench encoder's cell levels) and the brick table gradient
// is filled only on the brick levels.
//
// The cell levels' adds. A match group's leader stages its 8F-lane row in
// its own shared-memory slot and adds it with one bulk reduction
// (cp.reduce.async.bulk .add.f32, sm_90, one 128-B reduce through the
// async proxy at F = 4). It was measured against 8 F-lane vector atomics
// a row, in turns in one run (chip_smoke.py phase 15 as it stood while
// both forms were built: the bench encoder's cell field, N = 262,144
// uniform, an H100 80GB HBM3 at 700 W): atomics 0.4273 and 0.4278 ms,
// bulk reductions 0.3854 and 0.3850 ms, the cell rows equal to the plain
// version's within 7.1e-9 of the largest entry either way. The bulk form
// is the one kept.
//
// What bounds K6c: as K6, the brick levels' atomics in the L2. Its needed
// bytes (x, g, rows and the table read; the brick levels' table gradient
// and d_x written once, the cell levels' rows being fold_cells' output and
// the cell rows an intermediate) take 0.108 ms at 3.35 TB/s at that input,
// its corner reads plus atomic payload 0.160 ms.
//
// K6 and K2: x [N, 3] f32, g [N, L*F] bf16, rows [L, N] i32 (level-local),
// src the table or the gathered rows (bf16) -> d_table [sum R_l, 64F]
// (accumulated into), d_cell [sum 27 R_l, 8F] for K6c (accumulated into),
// d_x [N, 3].
// Block (32, L): threadIdx.x is the sample, threadIdx.y the level; with
// kCell, 32 * L * 8F floats of dynamic shared memory (a slot a thread).
template <int F, Rows kRows, bool kCell>
__global__ void __launch_bounds__(kBwdSamples * kMaxLevels)
    encode_bwd_kernel(const float* __restrict__ x,
                      const __nv_bfloat16* __restrict__ g,
                      const int* __restrict__ rows,
                      const __nv_bfloat16* __restrict__ src, Levels lv,
                      int n_levels, long long n, float* __restrict__ d_table,
                      float* __restrict__ d_cell, float* __restrict__ d_x) {
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
  const unsigned act = __ballot_sync(0xffffffffu, any);
  if (any) {  // else every term of this (sample, level) is zero
    const float scale = lv.scale[l];
    int r = __ldg(rows + (long long)l * n + i);
    r = min(max(r, 0), lv.rows[l] - 1);
    const long long trow = lv.offset[l] + r;
    const float p[3] = {__ldg(x + i * 3), __ldg(x + i * 3 + 1),
                        __ldg(x + i * 3 + 2)};
    int ia[3];
    float w[3][2], ok[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      axis_geom(p[a], scale, lv.nb[l], ia[a], w[a][1], w[a][0], ok[a]);
    const __nv_bfloat16* row =
        src + (kRows == Rows::kTable ? trow : (long long)l * n + i) * W;
    ZLine<F> line[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      line[q] = load_zline<F>(
          row + ((ia[0] + (q >> 1)) * 16 + (ia[1] + (q & 1)) * 4) * F);
    float* drow = d_table + trow * W;
    float s[3] = {0.0f, 0.0f, 0.0f};
    float upd[8][F];
    // K6c's cell levels form the update terms as the JAX cell levels do in
    // bf16: each axis weight bf16(frac) or bf16(1 - bf16(frac)), w =
    // (wx * wy) * wz and w * g each rounded to bf16 (an f32 product of
    // two bf16 values is exact, so one rounding gives the bf16 product)
    const bool cell = kCell && lv.cell[l] >= 0;
    float wb[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      wb[a][1] = bf16r(w[a][1]);
      wb[a][0] = bf16r(1.0f - wb[a][1]);
    }
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
        const float wc = w[0][kx] * wyz;
        const float wcb = bf16r(bf16r(wb[0][kx] * wb[1][ky]) * wb[2][kz]);
#pragma unroll
        for (int f = 0; f < F; ++f)
          upd[q * 2 + kz][f] = cell ? bf16r(wcb * gf[f]) : wc * gf[f];
        // d w_c / d frac_a = +-(product of the other two axes' weights)
        s[0] += (kx ? h : -h) * wyz;
        s[1] += (ky ? h : -h) * (w[0][kx] * w[2][kz]);
        s[2] += (kz ? h : -h) * (w[0][kx] * w[1][ky]);
      }
    }
    // Lanes of this warp (one level) whose samples lie in the same cell
    // share all 8 corners: their terms are summed by a shuffle tree over the
    // match group (each step adds the next remaining peer's sums, and the
    // peers of odd rank drop out), and the group's first lane adds them.
    const unsigned key =
        (unsigned)r * 27u + (unsigned)(ia[0] * 9 + ia[1] * 3 + ia[2]);
    const unsigned peers = __match_any_sync(act, key);
    const bool leader = lane == __ffs(peers) - 1;
    int rank = __popc(peers & ((1u << lane) - 1u));
    unsigned above = peers & (0xfffffffeu << lane);
    while (__any_sync(act, above)) {
      const int next = __ffs(above);
      const int peer = next ? next - 1 : lane;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float t = __shfl_sync(act, upd[c][f], peer);
          if (next) upd[c][f] += t;
        }
      }
      above &= ~__ballot_sync(act, rank & 1);
      rank >>= 1;
    }
    if (leader) {
      if (cell) {
        float* crow = d_cell + (lv.cell[l] + (long long)key) * (8 * F);
        extern __shared__ float4 s_bulk[];
        float* slot = reinterpret_cast<float*>(s_bulk) +
                      (l * kBwdSamples + lane) * (8 * F);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int f = 0; f < F; ++f) slot[c * F + f] = upd[c][f];
        }
        bulk_add_row<8 * F * 4>(crow, slot);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int corner = (ia[0] + (c >> 2)) * 16 +
                             (ia[1] + ((c >> 1) & 1)) * 4 + ia[2] + (c & 1);
          add_corner<F>(drow + corner * F, upd[c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) dxl[a] = s[a] * ok[a] * scale;
  }
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
               float* d_table, float* d_x, void* stream,
               const long long* cell_rows = nullptr,
               float* d_cell = nullptr) {
  Levels lv;
  if (!bwd_args_ok(lv, n, n_levels, n_feat, scales, nbs, level_rows,
                   cell_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid =
      (unsigned int)((n + kBwdSamples - 1) / kBwdSamples);
  const dim3 block(kBwdSamples, n_levels);
  // kCell: a thread's shared-memory slot of 8F f32 (its cell row); above
  // the default 48 KB (L * F > 12) the kernel has to be allowed more
  constexpr int kDefaultSmem = 48 * 1024;
  const int smem = kCell ? kBwdSamples * n_levels * 8 * n_feat * 4 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
  const __nv_bfloat16* sb = static_cast<const __nv_bfloat16*>(src);
  switch (n_feat) {
    case 1:
      if (smem > kDefaultSmem)
        cudaFuncSetAttribute(encode_bwd_kernel<1, kRows, kCell>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
      encode_bwd_kernel<1, kRows, kCell><<<grid, block, smem, st>>>(
          x, gb, rows, sb, lv, n_levels, n, d_table, d_cell, d_x);
      break;
    case 2:
      if (smem > kDefaultSmem)
        cudaFuncSetAttribute(encode_bwd_kernel<2, kRows, kCell>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
      encode_bwd_kernel<2, kRows, kCell><<<grid, block, smem, st>>>(
          x, gb, rows, sb, lv, n_levels, n, d_table, d_cell, d_x);
      break;
    default:
      if (smem > kDefaultSmem)
        cudaFuncSetAttribute(encode_bwd_kernel<4, kRows, kCell>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
      encode_bwd_kernel<4, kRows, kCell><<<grid, block, smem, st>>>(
          x, gb, rows, sb, lv, n_levels, n, d_table, d_cell, d_x);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cednerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K6. x [N,3] f32, g [N, L*F] bf16, rows [L, N] i32 (level-local), table
// [sum R_l, 64F] bf16 -> d_table [sum R_l, 64F] f32 (accumulated into: the
// caller zeroes it), d_x [N, 3] f32. Returns cudaGetLastError().
int brick_fused_encode_bwd(const float* x, const void* g, const int* rows,
                           const void* table, int n_levels, long long n,
                           int n_feat, const float* scales, const int* nbs,
                           const int* level_rows, float* d_table, float* d_x,
                           void* stream) {
  return launch_bwd<Rows::kTable>(x, g, rows, table, n_levels, n, n_feat,
                                  scales, nbs, level_rows, d_table, d_x,
                                  stream);
}

// K6c. As K6, and cell_rows [L] i64: level l's first row in d_cell
// [sum 27 R_l, 8F] f32 (accumulated into: zero on entry, the wrapper's
// resident buffer), or -1 for a level whose gradient goes to d_table as in
// K6.
int brick_fused_encode_bwd_cell(const float* x, const void* g,
                                const int* rows, const void* table,
                                int n_levels, long long n, int n_feat,
                                const float* scales, const int* nbs,
                                const int* level_rows,
                                const long long* cell_rows, float* d_table,
                                float* d_cell, float* d_x, void* stream) {
  return launch_bwd<Rows::kTable, true>(x, g, rows, table, n_levels, n,
                                        n_feat, scales, nbs, level_rows,
                                        d_table, d_x, stream, cell_rows,
                                        d_cell);
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

// K2. As K6 with feats [L, N, 64F] bf16 in place of the table.
int brick_interp_bwd_fused(const float* x, const void* g, const int* rows,
                           const void* feats, int n_levels, long long n,
                           int n_feat, const float* scales, const int* nbs,
                           const int* level_rows, float* d_table, float* d_x,
                           void* stream) {
  return launch_bwd<Rows::kGathered>(x, g, rows, feats, n_levels, n, n_feat,
                                     scales, nbs, level_rows, d_table, d_x,
                                     stream);
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
