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
//   K7 brick_interp_bwd        <- cednerf_tpu/ops/pallas_encoder.py::
//                                 _build_bwd (public interp_bwd): K1's
//                                 backward that writes every level's update
//                                 rows [L, N, 64F] for the caller to scatter
//                                 (K3) instead of accumulating them; see the
//                                 note above interp_bwd_rows_kernel.
//
// Both compute, for every (sample, level), the gradient of
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
// d_x is summed over the levels in level order in registers and written
// once per sample, so it is deterministic.
//
// What bounds them on this card: the scattered f32 atomics (N*L*8*F of
// them: 67M at one train step's N = 262,144, L8 F4) and, for K6, the
// 8 random 8-byte corner reads per (sample, level); a level of 216 bricks
// takes ~1,200 atomics per address. A thread per sample walks its levels in
// order; a level whose cotangent is all zero (an unused budget slot) skips
// its atomics. Shared-memory or warp-aggregated accumulation for the dense
// coarse levels is a lever for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kBlock = 128;

struct Levels {
  float scale[kMaxLevels];
  int nb[kMaxLevels];            // bricks per axis
  int rows[kMaxLevels];          // table rows of the level (row indices are
                                 // clamped to it, as in the plain version)
  long long offset[kMaxLevels];  // first row of the level in the flat table
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

// kGather: K6 (src is the flat table [sum R_l, 64F], rows index it per
// level); otherwise K2 (src is feats [L, N, 64F], row i of level l).
template <int F, bool kGather>
__global__ void __launch_bounds__(kBlock)
    encode_bwd_kernel(const float* __restrict__ x,
                      const __nv_bfloat16* __restrict__ g,
                      const int* __restrict__ rows,
                      const __nv_bfloat16* __restrict__ src, Levels lv,
                      int n_levels, long long n, float* __restrict__ d_table,
                      float* __restrict__ d_x) {
  constexpr int W = 64 * F;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float p[3] = {x[i * 3], x[i * 3 + 1], x[i * 3 + 2]};
  float dx[3] = {0.0f, 0.0f, 0.0f};
  const __nv_bfloat16* gi = g + i * (long long)(n_levels * F);
  for (int l = 0; l < n_levels; ++l) {
    float gf[F];
    bool any = false;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      gf[f] = __bfloat162float(gi[l * F + f]);
      any |= gf[f] != 0.0f;
    }
    if (!any) continue;  // every term of this level is zero
    int r = rows[(long long)l * n + i];
    r = min(max(r, 0), lv.rows[l] - 1);
    const long long trow = lv.offset[l] + r;
    const __nv_bfloat16* row =
        kGather ? src + trow * W : src + ((long long)l * n + i) * W;
    float* drow = d_table + trow * W;
    int ia[3];
    float w[3][2], ok[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      axis_geom(p[a], lv.scale[l], lv.nb[l], ia[a], w[a][1], w[a][0], ok[a]);
    float s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const int kx = c8 >> 2, ky = (c8 >> 1) & 1, kz = c8 & 1;
      const int corner = (ia[0] + kx) * 16 + (ia[1] + ky) * 4 + (ia[2] + kz);
      const float wyz = w[1][ky] * w[2][kz];
      const float wc = w[0][kx] * wyz;
      float v[F];
      load_corner<F>(row + corner * F, v);
      float h = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        h = fmaf(v[f], gf[f], h);
        atomicAdd(drow + corner * F + f, wc * gf[f]);
      }
      // d w_c / d frac_a = +-(product of the other two axes' weights)
      s[0] += (kx ? h : -h) * wyz;
      s[1] += (ky ? h : -h) * (w[0][kx] * w[2][kz]);
      s[2] += (kz ? h : -h) * (w[0][kx] * w[1][ky]);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) dx[a] += s[a] * ok[a] * lv.scale[l];
  }
  d_x[i * 3] = dx[0];
  d_x[i * 3 + 1] = dx[1];
  d_x[i * 3 + 2] = dx[2];
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
// (d_x summed in registers, as K2) and its 3 x 4 per-axis corner weights and
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

bool fill_levels(Levels& lv, int n_levels, const float* scales, const int* nbs,
                 const int* level_rows) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  long long off = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.scale[l] = scales[l];
    lv.nb[l] = nbs[l];
    lv.rows[l] = level_rows ? level_rows[l] : 0;
    lv.offset[l] = off;
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

template <bool kGather>
int launch(const float* x, const void* g, const int* rows, const void* src,
           int n_levels, long long n, int n_feat, const float* scales,
           const int* nbs, const int* level_rows, float* d_table, float* d_x,
           void* stream) {
  Levels lv;
  if (n <= 0 || !fill_levels(lv, n_levels, scales, nbs, level_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = (unsigned int)((n + kBlock - 1) / kBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
  const __nv_bfloat16* sb = static_cast<const __nv_bfloat16*>(src);
  switch (n_feat) {
    case 1:
      encode_bwd_kernel<1, kGather><<<grid, kBlock, 0, st>>>(
          x, gb, rows, sb, lv, n_levels, n, d_table, d_x);
      break;
    case 2:
      encode_bwd_kernel<2, kGather><<<grid, kBlock, 0, st>>>(
          x, gb, rows, sb, lv, n_levels, n, d_table, d_x);
      break;
    case 4:
      encode_bwd_kernel<4, kGather><<<grid, kBlock, 0, st>>>(
          x, gb, rows, sb, lv, n_levels, n, d_table, d_x);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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
  return launch<true>(x, g, rows, table, n_levels, n, n_feat, scales, nbs,
                      level_rows, d_table, d_x, stream);
}

// K2. As K6 with feats [L, N, 64F] bf16 in place of the table.
int brick_interp_bwd_fused(const float* x, const void* g, const int* rows,
                           const void* feats, int n_levels, long long n,
                           int n_feat, const float* scales, const int* nbs,
                           const int* level_rows, float* d_table, float* d_x,
                           void* stream) {
  return launch<false>(x, g, rows, feats, n_levels, n, n_feat, scales, nbs,
                       level_rows, d_table, d_x, stream);
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
