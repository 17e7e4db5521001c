// Row gather for Hopper (sm_90a), bound through ctypes by
// cednerf_torch/ops/gather_kernels.py, which also holds its plain PyTorch
// version.
//
// What it replaces:
//   K8 row_gather  <- cednerf_tpu/ops/pallas_gather.py::_gather_kernel
//                     (public dma_gather): out[i, :] = table[idx[i], :], one
//                     row DMA per index, `depth` of them in flight per
//                     sequential grid step of `tile` rows.
//
// Here an index outside [0, n_rows) gives a row of zeros (the TPU kernel
// copies from wherever it points; jnp.take fills NaN). Any N, any W; the
// bytes are copied as they are (bf16 and f32 tables), so the result equals
// the plain version bit for bit.
//
// What bounds it on this card: the bytes. The output is written once (N x W
// x elem bytes) and each distinct table row is read once (at the probe's
// defaults, R = 442,368 rows of 256 bf16 and N = 1,048,576 random indices,
// ~401,000 distinct rows: 537 MB written + 205 MB read + 4 MB of index,
// ~0.22 ms at 3.35 TB/s). There is no arithmetic.
//
// Design. Each lane moves 16 bytes. A row is taken by a group of tpr lanes
// (the power of two >= its 16-byte words, at most a warp): a warp per
// 512-byte row (W = 256 bf16), half a warp per 256-byte row (W = 128), the
// group looping over the words of a wider row. The TPU's `depth` becomes
// U, the rows each group keeps in flight: a lane issues U independent
// 16-byte loads, one per row, before its first store, so a warp has U
// (at 512 B) or 2U (at 256 B) rows in flight. Loads go through the
// read-only path, stores stream (the output is not read again here). A
// table or output that is not 16-byte aligned, or rows whose bytes are not
// a multiple of 16, take a scalar kernel (one element per lane).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 16;

unsigned grid_for(long long items, long long per_block) {
  const long long want = (items + per_block - 1) / per_block;
  return (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
}

template <int U>
__global__ void __launch_bounds__(kThreads)
    gather_vec_kernel(const uint4* __restrict__ table,
                      const int* __restrict__ idx, long long n, int wpr,
                      int tpr, int n_rows, uint4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int sub = lane / tpr;            // the lane's row within the warp
  const int lw = lane - sub * tpr;       // its first word within the row
  const int rpw = 32 / tpr;              // rows a warp takes per load
  const long long step = (long long)rpw * U;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * kWarps;
  for (long long base = warp * step; base < n; base += n_warps * step) {
    long long src[U];  // first word of the table row; -1 zero row; -2 none
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * rpw + sub;
      src[u] = -2;
      if (i < n) {
        const int r = __ldg(idx + i);
        src[u] = (r >= 0 && r < n_rows) ? (long long)r * wpr : -1;
      }
    }
    for (int w = lw; w < wpr; w += tpr) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (src[u] >= 0) v[u] = __ldg(table + src[u] + w);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (src[u] != -2)
          __stcs(out + (base + (long long)u * rpw + sub) * wpr + w, v[u]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_scalar_kernel(const T* __restrict__ table,
                         const int* __restrict__ idx, long long n, int w,
                         int n_rows, T* __restrict__ out) {
  const long long total = n * w;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
       j < total; j += stride) {
    const long long i = j / w;
    const int r = __ldg(idx + i);
    out[j] = (r >= 0 && r < n_rows) ? table[(long long)r * w + (j - i * w)]
                                    : T(0);
  }
}

template <int U>
void launch_vec(const void* table, const int* idx, long long n, int wpr,
                int n_rows, void* out, cudaStream_t st) {
  int tpr = 1;
  while (tpr < wpr && tpr < 32) tpr *= 2;
  const long long rows_per_block = (long long)kWarps * (32 / tpr) * U;
  gather_vec_kernel<U><<<grid_for(n, rows_per_block), kThreads, 0, st>>>(
      static_cast<const uint4*>(table), idx, n, wpr, tpr, n_rows,
      static_cast<uint4*>(out));
}

}  // namespace

extern "C" {

const char* cednerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table [n_rows, w] of elem_bytes (2 or 4) each, idx [n] i32 -> out [n, w];
// rows_in_flight U in {1, 2, 4, 8, 16}. Returns cudaGetLastError() after
// the launch (0 on success).
int row_gather(const void* table, const int* idx, long long n, int w,
               int n_rows, int elem_bytes, int rows_in_flight, void* out,
               void* stream) {
  if (n < 0 || w < 0 || n_rows < 0 || (elem_bytes != 2 && elem_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || w == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long row_bytes = (long long)w * elem_bytes;
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const int wpr = (int)(row_bytes / 16);
    switch (rows_in_flight) {
      case 1: launch_vec<1>(table, idx, n, wpr, n_rows, out, st); break;
      case 2: launch_vec<2>(table, idx, n, wpr, n_rows, out, st); break;
      case 4: launch_vec<4>(table, idx, n, wpr, n_rows, out, st); break;
      case 8: launch_vec<8>(table, idx, n, wpr, n_rows, out, st); break;
      case 16: launch_vec<16>(table, idx, n, wpr, n_rows, out, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (elem_bytes == 2) {
    gather_scalar_kernel<uint16_t><<<grid_for(n * w, kThreads), kThreads, 0,
                                     st>>>(
        static_cast<const uint16_t*>(table), idx, n, w, n_rows,
        static_cast<uint16_t*>(out));
  } else {
    gather_scalar_kernel<uint32_t><<<grid_for(n * w, kThreads), kThreads, 0,
                                     st>>>(
        static_cast<const uint32_t*>(table), idx, n, w, n_rows,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
