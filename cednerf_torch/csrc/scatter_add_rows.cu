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
// out [n_rows, W] f32 = 0 (unless the caller adds into it), then
// out[rows[i], :] += upd[i, :] for i in [0, M). A row index outside
// [0, n_rows) is dropped. upd is f32 (the 4D encoder's update rows, upd *
// (1 - t_frac) promoted to f32) or bf16.
//
// The TPU kernel keeps the whole accumulator in VMEM and walks the rows in
// order on one core (ALIGN-8 windows with a one-hot select, n % tile == 0,
// the table <= 12 MiB of VMEM), so its sums take one order on every run.
// Blocks on this card run in no order; here the rows are summed in a fixed
// order without atomics (csrc/ordered_reduce.cuh): the row indices sorted
// stably by csrc/key_sort.cuh (exported below as key_sort, int32 keys and
// index, over the bits n_rows needs), rows_reduce_kernel walks the sorted
// entries in tiles of `tile`, one warp a (tile, column chunk), and adds
// each run of one output row in sorted order (ascending i) in registers,
// then stores it over the zeroed output row (or, when the caller adds into
// its own buffer, adds it with plain read-modify-writes), or leaves a
// partial row of a run that crosses a tile edge, which the carry folded
// into the same launch adds in tile order (ordered::fold_carry: whoever
// arrives last at the run's counter). Any M, any W, any n_rows.
//
// Columns. At f32 with W % 4 == 0 and 16-byte aligned rows, a lane holds 4
// consecutive lanes of the row (one 16-byte load an update row, 512 B a
// warp); else a lane holds one (bf16 updates, odd widths). Each warp loads
// eight update rows before it adds the first of them, so that eight loads
// are in flight: a warp's sum is a chain of dependent adds, its loads are
// not. Narrow rows (W <= kNarrow) would leave most of a warp idle that way
// (W = 4 at f32: 1 lane of 32), so rows_reduce_narrow_kernel gives a tile
// to W threads (W rounded up to a power of two), one column each, and a
// warp walks 32 / W tiles at once. Every form adds a column's entries in
// the same order, so on the same tiles they give the same bits.
//
// Narrow rows are what the model paths send: the tri-plane's texel
// gradient (W = F = 4, 25.2 M entries a step at N = 262,144) and the 4D
// brick levels' corner entries (one F-wide entry a (keyframe slot, sample,
// corner), key = keyframe row * 64 + corner, ops/brick_grid.py). A
// thread's loads there are random 16-byte reads (a 32-byte sector each)
// through the index, so the narrow kernel loads the sorted keys and the
// index of kNarrowDepth entries together (neither waits for the other),
// then their kNarrowDepth terms, all in flight at once; the wrapper gives
// narrow rows tiles of NARROW_TILE entries (ops/scatter_kernels.py), which
// cuts the carry's work (a run that crosses a tile edge) where texel runs
// are long, with a tile's serial chain still short beside its loads.
//
// What bounds it on this card: the bytes. Every lane of upd is read once,
// the row indices read, the table written once (read and written where
// the caller adds into it): ~0.17 ms at 3.35 TB/s for a hashed level's
// 2N x 1,024 B of f32 rows at the train step's N = 262,144, 0.02 ms for
// its 2N x 8 narrow corner entries. This design adds the sort's traffic
// (csrc/key_sort.cuh) and the sorted keys and index read (8 B an entry).
// Its earlier forms: float4 corners with atomics (0.265 ms there on an
// H100 80GB HBM3 at 700 W, in an order that changed from run to run), then
// torch.sort with a 64-bit index (0.373 ms), then a separate carry launch
// (0.501 ms by events on 4.2 M corner entries, 0.491 with the carry folded
// in; chip_smoke.py --sort_ab, the same card).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "key_sort.cuh"
#include "ordered_reduce.cuh"

namespace {

constexpr int kWarps = 4;    // warps of a block, each its own (tile, chunk)
constexpr int kDepth = 8;    // update rows a warp loads before adding
constexpr int kNarrow = 16;  // widths up to this take the narrow kernel
constexpr int kNarrowDepth = 32;  // entries a narrow thread loads at once

template <int V>
struct Vec;
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(float (&v)[4], const float* p) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void add(float* p, const float (&v)[4]) {
    float4* q = reinterpret_cast<float4*>(p);
    const float4 o = *q;
    *q = make_float4(__fadd_rn(o.x, v[0]), __fadd_rn(o.y, v[1]),
                     __fadd_rn(o.z, v[2]), __fadd_rn(o.w, v[3]));
  }
};
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(float (&v)[1], const float* p) {
    v[0] = __ldcs(p);
  }
  static __device__ __forceinline__ void load(float (&v)[1],
                                              const __nv_bfloat16* p) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    *p = v[0];
  }
  static __device__ __forceinline__ void add(float* p, const float (&v)[1]) {
    *p = __fadd_rn(*p, v[0]);
  }
};

// keys [E] i32 sorted stably, perm [E] i32 (input row of each entry), upd
// [M, w] (T), d.a = out [n_rows, w] f32 (d.add: added into, else zeroed
// and stored over), carry.part [2, tiles, w] f32 scratch and carry.count the
// arrival counters, `chunks` a tile. A warp takes tile t = task / chunks
// and the V*32 columns of chunk task % chunks, and folds the carry of its
// chunk's columns.
template <typename T, int V>
__global__ void __launch_bounds__(kWarps * 32)
    rows_reduce_kernel(const int* __restrict__ keys,
                       const int* __restrict__ perm,
                       long long n_entries, int tile,
                       const T* __restrict__ upd, int w, ordered::Dest d,
                       ordered::Carry carry, long long tiles, int chunks) {
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= tiles * chunks) return;  // a whole warp; no block barrier
  const long long t = task / chunks;
  const int chunk = (int)(task - t * chunks);
  const int col = chunk * 32 * V + lane * V;
  const bool live = col < w;
  const ordered::Tile tl = ordered::tile_of(keys, n_entries, t, tile);
  const ordered::Runs runs =
      ordered::crossing_runs(keys, tl, t, tile, tiles, d);
  float acc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = 0.0f;
  int cur = __ldg(keys + tl.s);
  long long run_a = tl.s;
  auto flush = [&](int k, long long a, long long b) {
    if (d.valid(k)) {
      const int target = ordered::run_target(tl, a, b, k);
      if (live) {
        if (target == 0 && d.add)
          Vec<V>::add(d.row(k) + col, acc);
        else if (target == 0)
          Vec<V>::store(d.row(k) + col, acc);
        else
          Vec<V>::store(carry.part + ((target - 1) * tiles + t) * w + col, acc);
      }
    }
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.0f;
  };
  for (long long p0 = tl.s; p0 < tl.e; p0 += 32) {
    const long long p = p0 + lane;
    int my_k = 0, my_j = 0;
    if (p < tl.e) {
      my_k = __ldg(keys + p);
      my_j = __ldg(perm + p);
    }
    const int cnt = (int)min((long long)32, tl.e - p0);
    for (int q0 = 0; q0 < cnt; q0 += kDepth) {
      float v[kDepth][V];
      int kq[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        kq[u] = __shfl_sync(ordered::kFull, my_k, (q0 + u) & 31);
        const int j = __shfl_sync(ordered::kFull, my_j, (q0 + u) & 31);
        if (q0 + u < cnt && live && d.valid(kq[u])) {
          Vec<V>::load(v[u], upd + (long long)j * w + col);
        } else {
#pragma unroll
          for (int c = 0; c < V; ++c) v[u][c] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (q0 + u < cnt) {
          if (kq[u] != cur) {
            flush(cur, run_a, p0 + q0 + u);
            cur = kq[u];
            run_a = p0 + q0 + u;
          }
#pragma unroll
          for (int c = 0; c < V; ++c) acc[c] = __fadd_rn(acc[c], v[u][c]);
        }
      }
    }
  }
  flush(cur, run_a, tl.e);
  ordered::fold_carry<V, true>(runs, tiles, d, carry, chunk, col, 1);
}

__device__ __forceinline__ float load1(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// As rows_reduce_kernel, with a tile walked by 2^lanes_log2 threads (one
// column each, those past w idle): thread gid takes tile gid >> lanes_log2
// and reads that tile's keys and indices itself, so the tiles of a warp
// go their own ways and nothing is shuffled. Per kNarrowDepth entries the
// keys and indices are loaded first, together (as int4 where `vec`), then
// the terms of the valid ones, then added in order. Each thread folds the
// carry of its own column (carry.count: w counters a tile).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    rows_reduce_narrow_kernel(const int* __restrict__ keys,
                              const int* __restrict__ perm,
                              long long n_entries, int tile,
                              const T* __restrict__ upd, int w,
                              int lanes_log2, ordered::Dest d,
                              ordered::Carry carry, long long tiles,
                              bool vec) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long t = gid >> lanes_log2;
  const int col = (int)(gid & ((1 << lanes_log2) - 1));
  if (t >= tiles || col >= w) return;
  const ordered::Tile tl = ordered::tile_of(keys, n_entries, t, tile);
  const ordered::Runs runs =
      ordered::crossing_runs(keys, tl, t, tile, tiles, d);
  float acc = 0.0f;
  int cur = __ldg(keys + tl.s);
  long long run_a = tl.s;
  auto flush = [&](int k, long long a, long long b) {
    if (d.valid(k)) {
      const int target = ordered::run_target(tl, a, b, k);
      if (target == 0) {
        float* dst = d.row(k) + col;
        *dst = d.add ? __fadd_rn(*dst, acc) : acc;
      } else {
        carry.part[((target - 1) * tiles + t) * w + col] = acc;
      }
    }
    acc = 0.0f;
  };
  for (long long p0 = tl.s; p0 < tl.e; p0 += kNarrowDepth) {
    int kq[kNarrowDepth], jq[kNarrowDepth];
    float v[kNarrowDepth];
    if (vec && p0 + kNarrowDepth <= tl.e) {  // 16-byte loads, 4 entries
#pragma unroll
      for (int u = 0; u < kNarrowDepth; u += 4) {
        const int4 k4 = __ldg(reinterpret_cast<const int4*>(keys + p0 + u));
        const int4 j4 = __ldg(reinterpret_cast<const int4*>(perm + p0 + u));
        kq[u] = k4.x; kq[u + 1] = k4.y; kq[u + 2] = k4.z; kq[u + 3] = k4.w;
        jq[u] = j4.x; jq[u + 1] = j4.y; jq[u + 2] = j4.z; jq[u + 3] = j4.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kNarrowDepth; ++u) {
        const long long p = p0 + u;
        kq[u] = p < tl.e ? __ldg(keys + p) : -1;
        jq[u] = p < tl.e ? __ldg(perm + p) : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kNarrowDepth; ++u)
      v[u] = d.valid(kq[u]) ? load1(upd + (long long)jq[u] * w + col) : 0.0f;
#pragma unroll
    for (int u = 0; u < kNarrowDepth; ++u) {
      if (p0 + u < tl.e) {
        if (kq[u] != cur) {
          flush(cur, run_a, p0 + u);
          cur = kq[u];
          run_a = p0 + u;
        }
        acc = __fadd_rn(acc, v[u]);
      }
    }
  }
  flush(cur, run_a, tl.e);
  ordered::fold_carry<1, false>(runs, tiles, d, carry, col, col, 1);
}

template <typename T>
void launch_narrow(const int* keys, const int* perm, long long m,
                   int tile, const void* upd, int w, const ordered::Dest& d,
                   float* part, int* count, cudaStream_t st) {
  const long long tiles = (m + tile - 1) / tile;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < w) ++lanes_log2;
  const long long threads = tiles << lanes_log2;
  // the keys and indices as int4 where every tile starts 16-byte aligned
  const bool vec = tile % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(perm) % 16 == 0;
  rows_reduce_narrow_kernel<T>
      <<<(unsigned)((threads + kWarps * 32 - 1) / (kWarps * 32)),
         kWarps * 32, 0, st>>>(keys, perm, m, tile,
                               static_cast<const T*>(upd), w, lanes_log2, d,
                               ordered::Carry{part, w, count, w}, tiles, vec);
}

template <typename T, int V>
void launch_reduce(const int* keys, const int* perm, long long m,
                   int tile, const void* upd, int w, const ordered::Dest& d,
                   float* part, int* count, cudaStream_t st) {
  const long long tiles = (m + tile - 1) / tile;
  const int chunks = (w + 32 * V - 1) / (32 * V);
  const long long tasks = tiles * chunks;
  rows_reduce_kernel<T, V>
      <<<(unsigned)((tasks + kWarps - 1) / kWarps), kWarps * 32, 0, st>>>(
          keys, perm, m, tile, static_cast<const T*>(upd), w, d,
          ordered::Carry{part, w, count, chunks}, tiles, chunks);
}

}  // namespace

extern "C" {

const char* cednerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// keys [m] i32: the row indices sorted stably (key_sort); perm [m] i32:
// the sort's indices (entry p is update row perm[p]); upd [m, w]
// (upd_bf16: bf16, else f32), out [n_rows, w] f32, part
// [2, ceil(m / tile), w] f32 scratch for the crossing runs' partial rows,
// count scatter_carry_counts(m, w, tile) int32 arrival counters, zero on
// entry and on return. Zeroes out (unless add: then out keeps what it
// holds), then adds each row's run, the carry folded in. Returns
// cudaGetLastError() after the launches (0 on success).
int scatter_add_rows(const int* keys, const int* perm, const void* upd,
                     long long m, int w, int n_rows, float* out, int upd_bf16,
                     int add, int tile, float* part, int* count,
                     void* stream) {
  if (m < 0 || w <= 0 || n_rows <= 0 || tile <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!add) {
    cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)n_rows * (size_t)w * sizeof(float), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const ordered::Dest d{out, n_rows, w, nullptr, 0, 0, add != 0};
  const bool vec = !upd_bf16 && w > kNarrow && w % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(upd) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(part) % 16 == 0;
  if (w <= kNarrow && upd_bf16)
    launch_narrow<__nv_bfloat16>(keys, perm, m, tile, upd, w, d, part, count,
                                 st);
  else if (w <= kNarrow)
    launch_narrow<float>(keys, perm, m, tile, upd, w, d, part, count, st);
  else if (vec)
    launch_reduce<float, 4>(keys, perm, m, tile, upd, w, d, part, count, st);
  else if (upd_bf16)
    launch_reduce<__nv_bfloat16, 1>(keys, perm, m, tile, upd, w, d, part,
                                    count, st);
  else
    launch_reduce<float, 1>(keys, perm, m, tile, upd, w, d, part, count, st);
  return static_cast<int>(cudaGetLastError());
}

// The stable sort of csrc/key_sort.cuh: keys [m] i32 -> keys_out [m] i32
// (sorted; outside [0, n_keys) as n_keys, last) and perm [m] i32, with
// scratch of key_sort_scratch_words(m, n_keys) int32 words. Returns
// cudaGetLastError() after the launches.
int key_sort(const int* keys, long long m, int n_keys, int* keys_out,
             int* perm, int* scratch, void* stream) {
  return keysort::sort(keys, m, n_keys, keys_out, perm, scratch,
                       static_cast<cudaStream_t>(stream));
}

long long key_sort_scratch_words(long long m, int n_keys) {
  return keysort::scratch_words(m, n_keys);
}

// The arrival counters scatter_add_rows needs: ceil(m / tile) tiles times
// the column groups that arrive apart (w for narrow rows, a warp's 32
// columns at most otherwise).
long long scatter_carry_counts(long long m, int w, int tile) {
  const long long tiles = (m + tile - 1) / tile;
  return tiles * (w <= kNarrow ? w : (w + 31) / 32);
}

}  // extern "C"
