// The z-line read of a brick row, shared by K5 and K1 (brick_encode_fwd.cu)
// and K6 and K2 (brick_encode_bwd.cu).
//
// A brick row holds the 4x4x4 corners of a brick, 64F bf16 values, lane =
// corner*F + f with corner = dx*16 + dy*4 + dz. A z-line is the 4 corners
// (dx, dy, 0..3): 4F bf16 = 8F bytes, aligned to 8F, read as two 16-byte
// loads at F = 4 (one 32-byte sector), one 16-byte load at F = 2 and one
// 8-byte load at F = 1. The 8 corners of a cell lie on 4 such lines.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// 4 corners x F bf16 as 2F 32-bit words (lane k*F + f of the line is the
// low half of word (k*F+f)/2 when even).
template <int F>
struct ZLine {
  uint32_t w[2 * F];
};

template <int F>
__device__ __forceinline__ ZLine<F> load_zline(const __nv_bfloat16* p) {
  ZLine<F> z;
  if constexpr (F == 4) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    z.w[0] = a.x; z.w[1] = a.y; z.w[2] = a.z; z.w[3] = a.w;
    z.w[4] = b.x; z.w[5] = b.y; z.w[6] = b.z; z.w[7] = b.w;
  } else if constexpr (F == 2) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    z.w[0] = a.x; z.w[1] = a.y; z.w[2] = a.z; z.w[3] = a.w;
  } else {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    z.w[0] = a.x; z.w[1] = a.y;
  }
  return z;
}

// Corner k (0..3 along z) of the line, feature f, as f32.
template <int F>
__device__ __forceinline__ float zval(const ZLine<F>& z, int k, int f) {
  const int e = k * F + f;
  const uint32_t word = z.w[e >> 1];
  return __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
}
