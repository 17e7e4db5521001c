// Brick-encoder forward kernels for Hopper (sm_90a), bound through ctypes by
// cednerf_torch/ops/encode_kernels.py, which also holds their plain PyTorch
// versions.
//
// What they replace:
//   K1 brick_interp_fwd        <- cednerf_tpu/ops/pallas_encoder.py::_build_fwd
//                                 (public interp_fwd): trilinear interpolation
//                                 of pre-gathered brick rows, all levels in one
//                                 pass.
//   K5 brick_fused_encode_fwd  <- cednerf_tpu/ops/pallas_fused.py::
//                                 _build_fused_fwd (public fused_encode_fwd):
//                                 K1 with the row gather inside the kernel.
//
// Layout (ops/brick_grid.py): a brick row holds the 4x4x4 corners of a brick,
// 64F bf16 values, lane = corner*F + f with corner = dx*16 + dy*4 + dz. A
// sample's cell inside the brick is intra in {0,1,2}^3 and its fraction
// frac in [0,1)^3; per axis the corner weight is (1-frac) at k == intra,
// frac at k == intra+1 and 0 elsewhere. Output [N, L*F], f32 accumulation,
// stored in the output dtype (bf16 or f32).
//
// K5. Only the 8 corners of a sample's cell carry weight, and they lie on 4
// z-lines of the 4^3 brick: (dx, dy) in {ix, ix+1} x {iy, iy+1}, each 4
// corners x F bf16 = 8F bytes aligned to 8F (zline.cuh, which K6 shares).
// K5 reads those 4 lines, 128 B per (sample, level)
// at F = 4 instead of the 512-B row, and weights corners iz and iz+1 of each
// line by compare-built z weights (the other two get weight 0: no branch on
// iz, and no 16-byte load at an 8-byte offset). One thread owns one
// (sample, level): a block is kBlock/L samples x L levels with the levels of
// a sample on adjacent lanes, so x is read once per group, the L levels' row
// fetches are in flight across lanes, and each lane writes its F outputs as
// one 8-byte (bf16) or 16-byte (f32) store, a warp's stores contiguous in
// [N, L*F]. The geometry is computed once per (sample, level), with no
// shuffles; the per-level constants are staged in shared memory once per
// block, since lanes index them by level. Products are summed in f32.
//
// What bounds K5 now: the corner sectors. N*L*4*8F bytes (2.15 GB for one
// 2M-sample seg-eval pass at L8 F4) against a 45.6 MB bf16 table that the
// 50 MB L2 nearly holds, so most of them are L2 hits; the HBM floor (the
// table, rows, x and the output once) is ~0.08 ms, the sector floor at HBM
// rate ~0.71 ms. It takes ~0.65 ms on uniform random samples and ~0.45 ms
// on ray-major ones (an H100 80GB HBM3 at 700 W).
//
// Tried on that card and dropped (each an edited copy of this source, timed
// beside it in one run): a warp per level (32 samples of one level
// per warp, as K6 has it), 0.724 against 0.648 ms on random samples and
// 0.453 against 0.447 on ray-major ones, its stores 8 bytes at a 64-byte
// stride; streaming hints on rows, x and the output (__ldcs, __stcs), 0.641
// and 0.447 ms, within 1%; an L2 access-policy window persisting the
// table, 0.796 against 0.652 ms: the card sets aside at most 32.8 MB for
// persisting lines, less than the 45.6 MB table, and the set-aside shrinks
// the L2 left to everything else. Not tried: staging level 0's 216 rows
// (110 KB) in shared memory, which serves one lane in eight, costs every
// block a 110-KB load, and saves reads of rows the L2 already holds.
//
// K1 is K5's design on rows the caller has already gathered, [L, N, 64F]:
// thread (l, i) reads the 4 z-lines of row (l, i), never the other 56
// corners. Those rows are read once and never again, so they come from HBM,
// not the L2: what bounds K1 is the 4 z-lines per (sample, level), N*L*4*8F
// bytes (2.15 GB for one 2M-sample seg-eval pass at L8 F4, 0.64 ms at 3.35
// TB/s). The two lines of one dx are 64 contiguous bytes at 128*ix + 32*iy
// (F = 4); for iy = 1 they straddle a 64-byte boundary, so an L2 that
// fetches 64-byte pairs moves up to ~1.33x those bytes. A thread owns two
// (sample, level) pairs and issues all their loads, through the read-only
// path, before any of their sums. Other settings, each built from this
// source and timed beside it in one run by a probe since removed (an H100
// 80GB HBM3 at 700 W): two pairs took 1.129 ms per pass, one pair per thread
// 1.188, four 1.139 (218 registers at F = 4), ld.global.cs (evict first)
// 1.188 with two pairs and 1.253 with one. K1's first design, a group of 8F
// lanes per sample, each loading 16 B of the 512-B row and the group's sums
// folded with shuffles, took 7.52 ms, 11x its bound.
//
// The TPU envelopes do not carry over: any N is accepted (the last group is
// masked, not padded to a tile), any F in {1, 2, 4}, no 128-lane view and no
// interleaved [2N, 2L] output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "zline.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kBlock = 256;
constexpr int kK1PerThread = 2;  // (sample, level) pairs a K1 thread owns

struct Levels {
  float scale[kMaxLevels];
  int nb[kMaxLevels];            // bricks per axis
  int rows[kMaxLevels];          // table rows of the level (K5 clamps to
                                 // it, as its plain version does)
  long long offset[kMaxLevels];  // first row of the level in the K5 table
};

// One axis of the cell geometry, bit-identical to the plain version (and to
// brick_grid._level_geom, which computes the host's rows): pos = x*scale +
// 0.5 rounded once to f32, the product formed exactly in f64 (24 x 24 bits)
// and the sum rounded in f64 and then to f32, with explicit _rn intrinsics
// so that nvcc contracts nothing. A different rounding of pos can move a
// sample that sits on a cell boundary into the neighbouring cell, away from
// the brick row the host computed for it.
__device__ __forceinline__ void axis_geom(float xa, float scale, int nb,
                                          int& intra, float& frac,
                                          float& one_minus) {
  const float pos = __double2float_rn(
      __dadd_rn(__dmul_rn((double)xa, (double)scale), 0.5));
  const float pg = floorf(pos);
  frac = __fsub_rn(pos, pg);
  one_minus = __fsub_rn(1.0f, frac);
  const int hi = nb * 3 - 1;
  int cell = (int)fminf(fmaxf(pg, -1.0f), (float)(hi + 1));
  cell = min(max(cell, 0), hi);
  intra = cell - (cell / 3) * 3;
}

// A sample's cell on one level: intra cell and fractions per axis (g = 1 -
// f).
struct Cell {
  int ix, iy, iz;
  float fx, fy, fz, gx, gy, gz;
};

__device__ __forceinline__ Cell cell_of(const float* __restrict__ x,
                                        long long i, float scale, int nb) {
  Cell c;
  axis_geom(__ldg(x + i * 3), scale, nb, c.ix, c.fx, c.gx);
  axis_geom(__ldg(x + i * 3 + 1), scale, nb, c.iy, c.fy, c.gy);
  axis_geom(__ldg(x + i * 3 + 2), scale, nb, c.iz, c.fz, c.gz);
  return c;
}

// The 4 z-lines of the cell in a brick row.
template <int F>
__device__ __forceinline__ void load_cell(const __nv_bfloat16* row,
                                          const Cell& c,
                                          ZLine<F> (&line)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    line[q] = load_zline<F>(
        row + ((c.ix + (q >> 1)) * 16 + (c.iy + (q & 1)) * 4) * F);
}

template <int F, typename OutT>
__device__ __forceinline__ void store_feats(OutT* dst, const float (&v)[F]);
template <>
__device__ __forceinline__ void store_feats<4, float>(float* dst,
                                                     const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store_feats<2, float>(float* dst,
                                                     const float (&v)[2]) {
  *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
}
template <>
__device__ __forceinline__ void store_feats<1, float>(float* dst,
                                                     const float (&v)[1]) {
  *dst = v[0];
}
template <>
__device__ __forceinline__ void store_feats<4, __nv_bfloat16>(
    __nv_bfloat16* dst, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&a);
  q.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(dst) = q;
}
template <>
__device__ __forceinline__ void store_feats<2, __nv_bfloat16>(
    __nv_bfloat16* dst, const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v[0], v[1]);
}
template <>
__device__ __forceinline__ void store_feats<1, __nv_bfloat16>(
    __nv_bfloat16* dst, const float (&v)[1]) {
  *dst = __float2bfloat16_rn(v[0]);
}

// The trilinear sum of the cell's 8 corners from its 4 z-lines, products
// in the plain version's order (wx * wy) * wz and summed in f32, stored as
// the F features of one (sample, level). Corners iz and iz+1 of each line
// get the compare-built z weights, the other two 0.
template <int F, typename OutT>
__device__ __forceinline__ void interp_store(const ZLine<F> (&line)[4],
                                             const Cell& c, OutT* dst) {
  float wz[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wz[k] = k == c.iz ? c.gz : (k == c.iz + 1 ? c.fz : 0.0f);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float wxy = ((q >> 1) ? c.fx : c.gx) * ((q & 1) ? c.fy : c.gy);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float w = wxy * wz[k];
#pragma unroll
      for (int f = 0; f < F; ++f)
        acc[f] = fmaf(w, zval<F>(line[q], k, f), acc[f]);
    }
  }
  store_feats<F, OutT>(dst, acc);
}

// K5: rows [L, N] i32 (level-local), x [N, 3] f32, table [sum R_l, 64F] bf16
// (levels concatenated, level l from row lv.offset[l]) -> out [N, L*F].
// Block (L, kBlock / L): threadIdx.x is the level, threadIdx.y the sample.
template <int F, typename OutT>
__global__ void __launch_bounds__(kBlock)
    fused_encode_fwd_kernel(const int* __restrict__ rows,
                            const float* __restrict__ x,
                            const __nv_bfloat16* __restrict__ table,
                            Levels lv, int n_levels, long long n,
                            OutT* __restrict__ out) {
  __shared__ float s_scale[kMaxLevels];
  __shared__ int s_nb[kMaxLevels];
  __shared__ int s_rows[kMaxLevels];
  __shared__ long long s_offset[kMaxLevels];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < n_levels) {
    s_scale[tid] = lv.scale[tid];
    s_nb[tid] = lv.nb[tid];
    s_rows[tid] = lv.rows[tid];
    s_offset[tid] = lv.offset[tid];
  }
  __syncthreads();
  const int l = threadIdx.x;
  const long long i = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= n) return;
  int r = __ldg(rows + (long long)l * n + i);
  r = min(max(r, 0), s_rows[l] - 1);
  const Cell c = cell_of(x, i, s_scale[l], s_nb[l]);
  ZLine<F> line[4];
  load_cell<F>(table + (s_offset[l] + r) * (64 * F), c, line);
  interp_store<F, OutT>(line, c, out + (i * n_levels + l) * F);
}

// K1: x [N, 3] f32, feats [L, N, 64F] bf16 (rows already gathered) -> out
// [N, L*F]. Block (L, kBlock / L) as K5's; a thread owns samples i0 + p *
// blockDim.y for p < kK1PerThread and loads all their z-lines before it
// sums any of them.
template <int F, typename OutT>
__global__ void __launch_bounds__(kBlock)
    interp_fwd_kernel(const float* __restrict__ x,
                      const __nv_bfloat16* __restrict__ feats, Levels lv,
                      int n_levels, long long n, OutT* __restrict__ out) {
  __shared__ float s_scale[kMaxLevels];
  __shared__ int s_nb[kMaxLevels];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < n_levels) {
    s_scale[tid] = lv.scale[tid];
    s_nb[tid] = lv.nb[tid];
  }
  __syncthreads();
  const int l = threadIdx.x;
  const long long i0 =
      (long long)blockIdx.x * blockDim.y * kK1PerThread + threadIdx.y;
  Cell c[kK1PerThread];
  ZLine<F> line[kK1PerThread][4];
#pragma unroll
  for (int p = 0; p < kK1PerThread; ++p) {
    const long long i = i0 + (long long)p * blockDim.y;
    if (i < n) {
      c[p] = cell_of(x, i, s_scale[l], s_nb[l]);
      load_cell<F>(feats + ((long long)l * n + i) * (64 * F), c[p], line[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < kK1PerThread; ++p) {
    const long long i = i0 + (long long)p * blockDim.y;
    if (i < n) interp_store<F, OutT>(line[p], c[p], out + (i * n_levels + l) * F);
  }
}

bool fill_levels(Levels& lv, int n_levels, const float* scales, const int* nbs,
                 const int* level_rows) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  long long off = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.scale[l] = scales[l];
    lv.nb[l] = nbs[l];
    lv.rows[l] = level_rows ? level_rows[l] : 1;
    lv.offset[l] = off;
    off += lv.rows[l];
  }
  return true;
}

template <typename OutT>
void launch_fused(int n_feat, cudaStream_t st, const int* rows, const float* x,
                  const __nv_bfloat16* table, const Levels& lv, int n_levels,
                  long long n, void* out) {
  OutT* o = static_cast<OutT*>(out);
  const dim3 block(n_levels, kBlock / n_levels);
  const unsigned int grid = (unsigned int)((n + block.y - 1) / block.y);
  switch (n_feat) {
    case 1:
      fused_encode_fwd_kernel<1, OutT><<<grid, block, 0, st>>>(
          rows, x, table, lv, n_levels, n, o);
      break;
    case 2:
      fused_encode_fwd_kernel<2, OutT><<<grid, block, 0, st>>>(
          rows, x, table, lv, n_levels, n, o);
      break;
    default:
      fused_encode_fwd_kernel<4, OutT><<<grid, block, 0, st>>>(
          rows, x, table, lv, n_levels, n, o);
      break;
  }
}

template <typename OutT>
void launch_interp(int n_feat, cudaStream_t st, const float* x,
                   const __nv_bfloat16* feats, const Levels& lv, int n_levels,
                   long long n, void* out) {
  OutT* o = static_cast<OutT*>(out);
  const dim3 block(n_levels, kBlock / n_levels);
  const long long per_block = (long long)block.y * kK1PerThread;
  const unsigned int grid = (unsigned int)((n + per_block - 1) / per_block);
  switch (n_feat) {
    case 1:
      interp_fwd_kernel<1, OutT><<<grid, block, 0, st>>>(x, feats, lv,
                                                         n_levels, n, o);
      break;
    case 2:
      interp_fwd_kernel<2, OutT><<<grid, block, 0, st>>>(x, feats, lv,
                                                         n_levels, n, o);
      break;
    default:
      interp_fwd_kernel<4, OutT><<<grid, block, 0, st>>>(x, feats, lv,
                                                         n_levels, n, o);
      break;
  }
}

bool feat_ok(int n_feat) { return n_feat == 1 || n_feat == 2 || n_feat == 4; }

}  // namespace

extern "C" {

const char* cednerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K5. Returns cudaGetLastError() after the launch (0 on success).
int brick_fused_encode_fwd(const int* rows, const float* x, const void* table,
                           int n_levels, long long n, int n_feat,
                           const float* scales, const int* nbs,
                           const int* level_rows, void* out, int out_f32,
                           void* stream) {
  Levels lv;
  if (n <= 0 || !feat_ok(n_feat) ||
      !fill_levels(lv, n_levels, scales, nbs, level_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* t = static_cast<const __nv_bfloat16*>(table);
  if (out_f32)
    launch_fused<float>(n_feat, st, rows, x, t, lv, n_levels, n, out);
  else
    launch_fused<__nv_bfloat16>(n_feat, st, rows, x, t, lv, n_levels, n, out);
  return static_cast<int>(cudaGetLastError());
}

// K1. Returns cudaGetLastError() after the launch (0 on success).
int brick_interp_fwd(const float* x, const void* feats, int n_levels,
                     long long n, int n_feat, const float* scales,
                     const int* nbs, void* out, int out_f32, void* stream) {
  Levels lv;
  if (n <= 0 || !feat_ok(n_feat) ||
      !fill_levels(lv, n_levels, scales, nbs, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* f = static_cast<const __nv_bfloat16*>(feats);
  if (out_f32)
    launch_interp<float>(n_feat, st, x, f, lv, n_levels, n, out);
  else
    launch_interp<__nv_bfloat16>(n_feat, st, x, f, lv, n_levels, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
