// Table-gradient row scatter-add for Hopper (sm_90a), bound through ctypes by
// cednerf_torch/ops/scatter_kernels.py, which also holds its plain PyTorch
// version.
//
// What it replaces:
//   K3 scatter_add_rows  <- cednerf_tpu/ops/pallas_scatter.py::
//                           scatter_add_rows (helper accum_rows_aligned): the
//                           standalone scatter-add that the 4D keyframe
//                           encoder's backward sends its update rows through.
//
// out [n_rows, W] f32 = 0, then out[rows[i], :] += upd[i, :] for i in [0, M).
// A row index outside [0, n_rows) is dropped. upd is f32 (the 4D encoder's
// update rows, upd * (1 - t_frac) promoted to f32) or bf16.
//
// The TPU kernel keeps the whole accumulator in VMEM and walks the rows in
// order on one core (ALIGN-8 windows with a one-hot select, n % tile == 0,
// the table <= 12 MiB of VMEM). Blocks on this card run in no order, so the
// sum is taken with f32 atomics in global memory, which the L2 resolves (the
// 4D field's tables run from 864 x 256 f32, 885 KB, to 65,536 x 256 f32,
// 67 MB, against a 50 MB L2), in an order that changes from run to run.
// Any M, any W, any n_rows.
//
// Zero lanes. Each 4D update row holds 8 corners x F nonzero values of its
// 64F lanes (and a zero cotangent row is zero throughout). Adding +-0 leaves
// an f32 sum unchanged, so a lane whose value is exactly 0 is skipped: at
// F = 4 one thread takes 4 lanes (one corner) as one 16-byte load and adds a
// nonzero corner with one vector atomicAdd on float4 (sm_90, global memory),
// which cuts the atomics per 256-lane row from 256 to 8. Rows that are not
// 16-byte aligned, W % 4 != 0 and bf16 rows take the scalar kernel (one
// atomic per nonzero lane).
//
// What bounds it on this card: the bytes. Every lane of upd has to be read
// to know it is zero: 2N x 1,024 B of f32 rows per level at the train step's
// N = 262,144 (537 MB), plus the table written once; about 0.18 ms at 3.35
// TB/s for a hashed level. The atomics (4.2M float4 per level) contend on
// the coarse dense level (864 rows: ~76 float4 adds per address on average
// at N = 262,144, more on the bricks a scene fills); shared-memory or
// warp-aggregated accumulation there is a lever for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 32;

unsigned grid_for(long long items) {
  const long long want = (items + kThreads - 1) / kThreads;
  return (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
}

// One float4 (4 lanes of one row) per thread and iteration; consecutive
// threads read consecutive 16 bytes. upd is read once: streaming loads.
__global__ void __launch_bounds__(kThreads)
    scatter_rows_vec4_kernel(const int* __restrict__ rows,
                             const float4* __restrict__ upd, long long m,
                             int w4, int n_rows, float* __restrict__ out) {
  const long long total = m * w4;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
       j < total; j += stride) {
    const float4 v = __ldcs(upd + j);
    if (v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f) continue;
    const long long i = j / w4;
    const int r = __ldg(rows + i);
    if (r < 0 || r >= n_rows) continue;
    float4* dst = reinterpret_cast<float4*>(out + (long long)r * (w4 * 4)) +
                  (j - i * w4);
    atomicAdd(dst, v);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_scalar_kernel(const int* __restrict__ rows,
                               const T* __restrict__ upd, long long m, int w,
                               int n_rows, float* __restrict__ out) {
  const long long total = m * w;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
       j < total; j += stride) {
    const float v = to_f32(upd[j]);
    if (v == 0.0f) continue;
    const long long i = j / w;
    const int r = __ldg(rows + i);
    if (r < 0 || r >= n_rows) continue;
    atomicAdd(out + (long long)r * w + (j - i * w), v);
  }
}

}  // namespace

extern "C" {

const char* cednerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rows [m] i32, upd [m, w] (upd_bf16: bf16, else f32), out [n_rows, w] f32.
// Zeroes out (unless add: then out keeps what it holds), then adds.
// Returns cudaGetLastError() after the launches (0 on success).
int scatter_add_rows(const int* rows, const void* upd, long long m, int w,
                     int n_rows, float* out, int upd_bf16, int add,
                     void* stream) {
  if (m < 0 || w <= 0 || n_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!add) {
    cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)n_rows * (size_t)w * sizeof(float), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = !upd_bf16 && w % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(upd) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    scatter_rows_vec4_kernel<<<grid_for(m * (w / 4)), kThreads, 0, st>>>(
        rows, static_cast<const float4*>(upd), m, w / 4, n_rows, out);
  } else if (upd_bf16) {
    scatter_rows_scalar_kernel<__nv_bfloat16>
        <<<grid_for(m * w), kThreads, 0, st>>>(
            rows, static_cast<const __nv_bfloat16*>(upd), m, w, n_rows, out);
  } else {
    scatter_rows_scalar_kernel<float><<<grid_for(m * w), kThreads, 0, st>>>(
        rows, static_cast<const float*>(upd), m, w, n_rows, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
