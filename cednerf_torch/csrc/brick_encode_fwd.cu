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
// K1 keeps its first design (a group of G = 8F lanes per sample, each lane
// loading 16 B of the gathered 512-B row, the group's partial sums folded
// with warp shuffles): the caller gathers its rows [L, N, 64F], so it is
// bound by reading them whole. K5 was first that design with the gather
// inside the kernel: it read all 64 corners of every row and spent ~200
// warp instructions per (sample, level) on lane weights and shuffles
// (8.915 ms per seg-eval pass on an H100 80GB HBM3 at 700 W, 110x its
// bound).
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
constexpr int kLoadBatch = 8;  // levels whose rows a lane loads before math

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

__device__ __forceinline__ float axis_weight(int k, int i, float f,
                                             float one_minus) {
  return k == i ? one_minus : (k == i + 1 ? f : 0.0f);
}

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Interpolate one level from this lane's 16-byte slice of the brick row and
// fold the group's partial sums; lane 0 of the group stores the F features.
template <int F, typename OutT>
__device__ __forceinline__ void interp_level(const uint4& v, int q, float px,
                                             float py, float pz, float scale,
                                             int nb, bool valid, OutT* dst) {
  constexpr int G = 8 * F;
  int ix, iy, iz;
  float fx, fy, fz, gx, gy, gz;
  axis_geom(px, scale, nb, ix, fx, gx);
  axis_geom(py, scale, nb, iy, fy, gy);
  axis_geom(pz, scale, nb, iz, fz, gz);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 ab = __bfloat1622float2(pairs[j]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = q * 8 + j * 2 + h;  // lane within the row
      const int c = e / F;              // corner = dx*16 + dy*4 + dz
      const float w = axis_weight(c >> 4, ix, fx, gx) *
                      axis_weight((c >> 2) & 3, iy, fy, gy) *
                      axis_weight(c & 3, iz, fz, gz);
      acc[(j * 2 + h) % F] = fmaf(w, h ? ab.y : ab.x, acc[(j * 2 + h) % F]);
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int f = 0; f < F; ++f)
      acc[f] += __shfl_xor_sync(0xffffffffu, acc[f], o);
  }
  if (q == 0 && valid) {
#pragma unroll
    for (int f = 0; f < F; ++f) dst[f] = to_out<OutT>(acc[f]);
  }
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
  const float scale = s_scale[l];
  const int nb = s_nb[l];
  int ix, iy, iz;
  float fx, fy, fz, gx, gy, gz;
  axis_geom(__ldg(x + i * 3), scale, nb, ix, fx, gx);
  axis_geom(__ldg(x + i * 3 + 1), scale, nb, iy, fy, gy);
  axis_geom(__ldg(x + i * 3 + 2), scale, nb, iz, fz, gz);
  const __nv_bfloat16* row = table + (s_offset[l] + r) * (64 * F);
  ZLine<F> line[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    line[q] = load_zline<F>(row +
                            ((ix + (q >> 1)) * 16 + (iy + (q & 1)) * 4) * F);
  float wz[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) wz[k] = axis_weight(k, iz, fz, gz);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // the plain version's product order: (wx * wy) * wz
    const float wxy = ((q >> 1) ? fx : gx) * ((q & 1) ? fy : gy);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float w = wxy * wz[k];
#pragma unroll
      for (int f = 0; f < F; ++f)
        acc[f] = fmaf(w, zval<F>(line[q], k, f), acc[f]);
    }
  }
  store_feats<F, OutT>(out + (i * n_levels + l) * F, acc);
}

// K1: feats [L, N, 64F] bf16 (rows already gathered), x [N, 3] f32
// -> out [N, L*F].
template <int F, typename OutT>
__global__ void __launch_bounds__(kBlock)
    interp_fwd_kernel(const float* __restrict__ x,
                      const uint4* __restrict__ feats, Levels lv, int n_levels,
                      long long n, OutT* __restrict__ out) {
  constexpr int G = 8 * F;
  constexpr int kRowVecs = 8 * F;
  const long long sample = ((long long)blockIdx.x * kBlock + threadIdx.x) / G;
  const int q = threadIdx.x % G;
  const bool valid = sample < n;
  const long long i = valid ? sample : n - 1;
  const float px = x[i * 3], py = x[i * 3 + 1], pz = x[i * 3 + 2];
  OutT* dst = out + i * (long long)(n_levels * F);
  for (int l0 = 0; l0 < n_levels; l0 += kLoadBatch) {
    uint4 v[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int l = l0 + j;
      if (l < n_levels)
        v[j] = __ldg(feats + ((long long)l * n + i) * kRowVecs + q);
    }
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int l = l0 + j;
      if (l < n_levels)
        interp_level<F, OutT>(v[j], q, px, py, pz, lv.scale[l], lv.nb[l],
                              valid, dst + l * F);
    }
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

unsigned int grid_for(long long n, int n_feat) {
  return (unsigned int)((n * 8 * n_feat + kBlock - 1) / kBlock);
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
void launch_interp(int n_feat, unsigned int grid, cudaStream_t st,
                   const float* x, const uint4* feats, const Levels& lv,
                   int n_levels, long long n, void* out) {
  OutT* o = static_cast<OutT*>(out);
  switch (n_feat) {
    case 1:
      interp_fwd_kernel<1, OutT><<<grid, kBlock, 0, st>>>(x, feats, lv,
                                                          n_levels, n, o);
      break;
    case 2:
      interp_fwd_kernel<2, OutT><<<grid, kBlock, 0, st>>>(x, feats, lv,
                                                          n_levels, n, o);
      break;
    default:
      interp_fwd_kernel<4, OutT><<<grid, kBlock, 0, st>>>(x, feats, lv,
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
  const unsigned int grid = grid_for(n, n_feat);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* f = static_cast<const uint4*>(feats);
  if (out_f32)
    launch_interp<float>(n_feat, grid, st, x, f, lv, n_levels, n, out);
  else
    launch_interp<__nv_bfloat16>(n_feat, grid, st, x, f, lv, n_levels, n,
                                 out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
