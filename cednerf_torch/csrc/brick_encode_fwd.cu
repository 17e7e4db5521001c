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
// What bounds them on this card: memory. Every (sample, level) reads one
// random 128F-byte row (512 B at F=4), about N*L*64F*2 bytes in all (8.6 GB
// for one 2M-sample seg-eval pass at L8F4), against ~2 flops per value. The
// design keeps those reads coalesced and in flight: a group of G = 8F lanes
// owns one sample, each lane loads 16 B of the row (so a 512-B row is one
// fully coalesced warp request), and each lane issues the loads of up to 8
// levels before it does any math, so a warp has 8 independent row requests
// outstanding. Lane weights are compare-built in registers, products are
// summed per feature and folded across the group with warp shuffles.
//
// Lever for a later PR, not taken here: only 8 of a row's 64 corners carry
// weight, so 7/8 of the bytes read are multiplied by zero. Reading just the
// 2x2x2 sub-block (or storing a cell-major table) would cut the traffic ~4-8x.
//
// The TPU envelopes do not carry over: any N is accepted (the last group is
// masked, not padded to a tile), any F in {1, 2, 4}, no 128-lane view and no
// interleaved [2N, 2L] output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// K5: rows [L, N] i32 (level-local), x [N, 3] f32, table [sum R_l, 64F] bf16
// (levels concatenated, level l from row lv.offset[l]) -> out [N, L*F].
template <int F, typename OutT>
__global__ void __launch_bounds__(kBlock)
    fused_encode_fwd_kernel(const int* __restrict__ rows,
                            const float* __restrict__ x,
                            const uint4* __restrict__ table, Levels lv,
                            int n_levels, long long n, OutT* __restrict__ out) {
  constexpr int G = 8 * F;
  constexpr int kRowVecs = 8 * F;  // 16-byte vectors per brick row
  const long long sample = ((long long)blockIdx.x * kBlock + threadIdx.x) / G;
  const int q = threadIdx.x % G;
  const bool valid = sample < n;
  const long long i = valid ? sample : n - 1;  // ragged edge: masked stores
  const float px = x[i * 3], py = x[i * 3 + 1], pz = x[i * 3 + 2];
  OutT* dst = out + i * (long long)(n_levels * F);
  for (int l0 = 0; l0 < n_levels; l0 += kLoadBatch) {
    uint4 v[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int l = l0 + j;
      if (l < n_levels) {
        int r = rows[(long long)l * n + i];
        r = min(max(r, 0), lv.rows[l] - 1);
        v[j] = __ldg(table + (lv.offset[l] + r) * kRowVecs + q);
      }
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
void launch_fused(int n_feat, unsigned int grid, cudaStream_t st,
                  const int* rows, const float* x, const uint4* table,
                  const Levels& lv, int n_levels, long long n, void* out) {
  OutT* o = static_cast<OutT*>(out);
  switch (n_feat) {
    case 1:
      fused_encode_fwd_kernel<1, OutT><<<grid, kBlock, 0, st>>>(
          rows, x, table, lv, n_levels, n, o);
      break;
    case 2:
      fused_encode_fwd_kernel<2, OutT><<<grid, kBlock, 0, st>>>(
          rows, x, table, lv, n_levels, n, o);
      break;
    default:
      fused_encode_fwd_kernel<4, OutT><<<grid, kBlock, 0, st>>>(
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

const char* brick_error_string(int code) {
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
  const unsigned int grid = grid_for(n, n_feat);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* t = static_cast<const uint4*>(table);
  if (out_f32)
    launch_fused<float>(n_feat, grid, st, rows, x, t, lv, n_levels, n, out);
  else
    launch_fused<__nv_bfloat16>(n_feat, grid, st, rows, x, t, lv, n_levels, n,
                                out);
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
