// The port's copy of csrc/weights.cpp, unchanged below this note: built with g++
// into cednerf_torch/_build/ by cednerf_torch/utils/host_build.py, so that the
// port builds only its own sources. tests/test_torch_datasets.py holds its
// results bit for bit against the original's.
//
// Native ISG/IST importance-weight precompute for DyNeRF-style scenes.
//
// Replaces the hot loops of tools/gen_isg_ist.py (the CLI port of the
// reference's gen_isg_ist.ipynb): per-pixel temporal medians, the ISG
// psi(diff^2/(diff^2+gamma^2)) map against them, and the IST
// max-|frame difference| map over +-frame_shift temporal shifts. At
// production DyNeRF sizes (21 cams x 300 frames x 676x507) the numpy
// versions churn through ~90 GB of temporaries; these kernels stream
// per pixel with OpenMP-free std::thread row slabs.
//
// Math parity targets (bit-level, gated by tests/test_native_weights.py):
//   * median: numpy semantics — even frame counts average the two middle
//     values, and the result is cast to uint8 with truncation
//     (cednerf_tpu/datasets/dynerf.py gen path / dnerf_3d_video.py:13-33);
//   * ISG: frames and medians scaled by 1/255; psi averaged over channels
//     (datasets/dynerf.py isg_weights);
//   * IST: raw 0..255 float units, missing neighbors compare against
//     zero frames (the reference's zero-padding), channel mean clamped
//     below at alpha (datasets/dynerf.py ist_weights /
//     dnerf_3d_video.py:36-54).
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename F>
void run_slabs(int64_t n, int threads, F&& fn) {
  if (threads < 1) threads = 1;
  int64_t chunk = (n + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([lo, hi, &fn] {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// imgs: [n_cams, n_frames, h*w, 3] uint8 (contiguous row-major).
// out:  [n_cams, h*w, 3] uint8 per-pixel-channel temporal median.
void cednerf_median_images(const uint8_t* imgs, int64_t n_cams,
                           int64_t n_frames, int64_t hw, int threads,
                           uint8_t* out) {
  const int64_t cam_stride = n_frames * hw * 3;
  run_slabs(n_cams * hw, threads, [=](int64_t job) {
    const int64_t cam = job / hw, px = job % hw;
    const uint8_t* base = imgs + cam * cam_stride + px * 3;
    uint8_t* o = out + (cam * hw + px) * 3;
    uint8_t vals[4096];
    for (int c = 0; c < 3; ++c) {
      for (int64_t f = 0; f < n_frames; ++f)
        vals[f] = base[f * hw * 3 + c];
      uint8_t* mid = vals + n_frames / 2;
      std::nth_element(vals, mid, vals + n_frames);
      if (n_frames % 2) {
        o[c] = *mid;
      } else {
        // numpy: mean of the two middle values, float, truncated by the
        // uint8 cast in the caller
        uint8_t lo = *std::max_element(vals, mid);
        o[c] = static_cast<uint8_t>((float(lo) + float(*mid)) * 0.5f);
      }
    }
  });
}

// ISG weights: out[cam, frame, px] = mean_c sq/(sq+gamma^2),
// sq = (img/255 - median/255)^2. out: [n_cams*n_frames*hw] float32.
void cednerf_isg_weights(const uint8_t* imgs, const uint8_t* medians,
                         int64_t n_cams, int64_t n_frames, int64_t hw,
                         float gamma, int threads, float* out) {
  const float g2 = gamma * gamma;
  const float inv255 = 1.0f / 255.0f;
  run_slabs(n_cams * n_frames, threads, [=](int64_t job) {
    const int64_t cam = job / n_frames;
    const uint8_t* im = imgs + job * hw * 3;
    const uint8_t* med = medians + cam * hw * 3;
    float* o = out + job * hw;
    for (int64_t p = 0; p < hw; ++p) {
      float acc = 0.0f;
      for (int c = 0; c < 3; ++c) {
        float d = (float(im[p * 3 + c]) - float(med[p * 3 + c])) * inv255;
        float sq = d * d;
        acc += sq / (sq + g2);
      }
      o[p] = acc * (1.0f / 3.0f);
    }
  });
}

// IST weights: out[cam, frame, px] =
//   max(alpha, mean_c max_{1<=s<=shift} |f[t+-s] - f[t]|)   (0..255 units;
// missing neighbors are zero frames). out: [n_cams*n_frames*hw] float32.
void cednerf_ist_weights(const uint8_t* imgs, int64_t n_cams,
                         int64_t n_frames, int64_t hw, float alpha,
                         int64_t frame_shift, int threads, float* out) {
  const int64_t cam_stride = n_frames * hw * 3;
  if (frame_shift > n_frames - 1) frame_shift = n_frames - 1;
  run_slabs(n_cams * n_frames, threads, [=](int64_t job) {
    const int64_t cam = job / n_frames, t = job % n_frames;
    const uint8_t* base = imgs + cam * cam_stride;
    const uint8_t* ft = base + t * hw * 3;
    float* o = out + job * hw;
    for (int64_t p = 0; p < hw; ++p) {
      float mc[3] = {0.0f, 0.0f, 0.0f};
      for (int64_t s = 1; s <= frame_shift; ++s) {
        const int64_t tf = t + s, tb = t - s;
        const uint8_t* pf =
            tf < n_frames ? base + (tf * hw + p) * 3 : nullptr;
        const uint8_t* pb = tb >= 0 ? base + (tb * hw + p) * 3 : nullptr;
        for (int c = 0; c < 3; ++c) {
          const float v = float(ft[p * 3 + c]);
          const float df = pf ? float(pf[c]) - v : -v;
          const float db = pb ? float(pb[c]) - v : -v;
          const float a = std::max(df < 0 ? -df : df, db < 0 ? -db : db);
          if (a > mc[c]) mc[c] = a;
        }
      }
      const float m = (mc[0] + mc[1] + mc[2]) * (1.0f / 3.0f);
      o[p] = m > alpha ? m : alpha;
    }
  });
}

}  // extern "C"
