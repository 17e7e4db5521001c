// The port's copy of csrc/raysampler.cpp, unchanged below this note: built with g++
// into cednerf_torch/_build/ by cednerf_torch/utils/host_build.py, so that the
// port builds only its own sources. tests/test_torch_datasets.py holds its
// results bit for bit against the original's.
//
// Native host-side ray-batch sampler for cednerf_tpu.
//
// The TPU-native equivalent of the runtime role that CUDA pip packages play
// in the reference: the device computes (XLA/Pallas); the host feeds it.
// For datasets too large for HBM (DyNeRF: ~5 GB of frames), per-step batch
// assembly in Python/numpy becomes the bottleneck — especially the
// importance-sampled multinomial draw over multi-million-entry weight maps
// (dnerf_3d_video_IS.py:401-440). This library does both multithreaded:
//
//   * sample_rays_pinhole: draw (image, x, y) triples (uniform or via an
//     inverse-CDF multinomial over a weight table), fetch pixels from the
//     uint8 image stack, and generate pinhole rays (+0.5 pixel centers,
//     optional OpenGL y/z flip — matching datasets/rays.py::pinhole_rays).
//   * build_cdf: prefix-sum normalization of a weight map (done once).
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// xoshiro256** — fast, high-quality, per-thread seedable PRNG.
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 init
    for (int i = 0; i < 4; i++) {
      seed += 0x9E3779B97f4A7C15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  inline uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  inline double uniform() { return (next() >> 11) * 0x1.0p-53; }
  inline int64_t randint(int64_t n) {
    return static_cast<int64_t>(uniform() * n);
  }
};

inline int64_t searchsorted(const double* cdf, int64_t n, double u) {
  int64_t lo = 0, hi = n;  // first index with cdf[i] > u
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (cdf[mid] <= u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < n ? lo : n - 1;
}

void parallel_for(int64_t n, int n_threads,
                  const std::function<void(int64_t, int64_t, int)>& fn) {
  if (n_threads <= 1) {
    fn(0, n, 0);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi, t);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Normalize weights into an inclusive-prefix CDF (returns total weight).
double cednerf_build_cdf(const float* weights, int64_t n, double* cdf_out) {
  double acc = 0.0;
  for (int64_t i = 0; i < n; i++) {
    acc += static_cast<double>(weights[i]);
    cdf_out[i] = acc;
  }
  if (acc > 0) {
    double inv = 1.0 / acc;
    for (int64_t i = 0; i < n; i++) cdf_out[i] *= inv;
  }
  return acc;
}

// Sample a pinhole ray batch.
//   images: [n_images, height, width, channels] uint8 (channels 3 or 4)
//   c2w:    [n_images, 12] row-major 3x4 camera-to-world
//   K:      [9] row-major 3x3 intrinsics
//   timestamps: [n_images]
//   cdf:    optional [n_images*ch_h*ch_w] pixel-weight CDF (pass nullptr for
//           uniform); weight maps may be 'subsample'x coarser than the
//           images: each drawn coarse index expands to a subsample^2 block
//           (dnerf_3d_video_IS.py:421-440) — n_rays must then be divisible
//           by subsample^2.
// Outputs: origins/viewdirs [n_rays, 3], pixels [n_rays, 3] in [0,1],
//          out_t [n_rays].
void cednerf_sample_rays(
    const uint8_t* images, int64_t n_images, int64_t height, int64_t width,
    int64_t channels, const float* c2w, const float* K,
    const float* timestamps, const double* cdf, int64_t subsample,
    const float* bkgd, int opengl, int64_t n_rays, uint64_t seed,
    int n_threads, float* out_origins, float* out_viewdirs,
    float* out_pixels, float* out_t) {
  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  const float sign = opengl ? -1.0f : 1.0f;
  const int64_t sub2 = subsample * subsample;
  const int64_t n_draws = cdf ? n_rays / sub2 : n_rays;
  const int64_t hsub = height / subsample;
  const int64_t wsub = width / subsample;

  // Draw (image, x, y) triples first (single pass; cheap), then fill rays
  // in parallel.
  std::vector<int64_t> img_id(n_rays), px(n_rays), py(n_rays);
  Rng rng(seed);
  if (cdf) {
    const int64_t n_cdf = n_images * hsub * wsub;
    for (int64_t d = 0; d < n_draws; d++) {
      int64_t idx = searchsorted(cdf, n_cdf, rng.uniform());
      int64_t im = idx / (hsub * wsub);
      int64_t ys = (idx % (hsub * wsub)) / wsub;
      int64_t xs = (idx % (hsub * wsub)) % wsub;
      for (int64_t ah = 0; ah < subsample; ah++) {
        for (int64_t aw = 0; aw < subsample; aw++) {
          int64_t r = d + n_draws * (ah * subsample + aw);
          img_id[r] = im;
          px[r] = xs * subsample + aw;
          py[r] = ys * subsample + ah;
        }
      }
    }
  } else {
    for (int64_t r = 0; r < n_rays; r++) {
      img_id[r] = rng.randint(n_images);
      px[r] = rng.randint(width);
      py[r] = rng.randint(height);
    }
  }

  parallel_for(n_rays, n_threads, [&](int64_t lo, int64_t hi, int) {
    for (int64_t r = lo; r < hi; r++) {
      const int64_t im = img_id[r];
      const float x = static_cast<float>(px[r]);
      const float y = static_cast<float>(py[r]);
      const float cdirs[3] = {
          (x - cx + 0.5f) / fx,
          (y - cy + 0.5f) / fy * sign,
          sign,
      };
      const float* m = c2w + im * 12;  // 3x4
      float dir[3];
      for (int i = 0; i < 3; i++) {
        dir[i] = cdirs[0] * m[i * 4 + 0] + cdirs[1] * m[i * 4 + 1] +
                 cdirs[2] * m[i * 4 + 2];
        out_origins[r * 3 + i] = m[i * 4 + 3];
      }
      const float inv_norm =
          1.0f / std::sqrt(dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2]);
      for (int i = 0; i < 3; i++) out_viewdirs[r * 3 + i] = dir[i] * inv_norm;

      const uint8_t* p =
          images + ((im * height + py[r]) * width + px[r]) * channels;
      if (channels == 4 && bkgd) {
        const float a = p[3] * (1.0f / 255.0f);
        for (int i = 0; i < 3; i++) {
          out_pixels[r * 3 + i] =
              p[i] * (1.0f / 255.0f) * a + bkgd[i] * (1.0f - a);
        }
      } else {
        for (int i = 0; i < 3; i++) {
          out_pixels[r * 3 + i] = p[i] * (1.0f / 255.0f);
        }
      }
      out_t[r] = timestamps[im];
    }
  });
}

}  // extern "C"
