// PNG scanline unfiltering for cednerf_torch/utils/image.py::decode_png.
//
// A PNG's inflated image data is one filter-type byte plus the filtered
// bytes of each row. Filters 1 (Sub), 3 (Average) and 4 (Paeth) predict a
// byte from the already-unfiltered byte `bpp` to its left, so a row is
// undone left to right, one byte after another: sequential work that
// numpy cannot vectorise, and the host cost of loading a D-NeRF scene
// (50 frames of 800x800 RGBA written with adaptive filters). Filter
// definitions: PNG specification (ISO/IEC 15948), section 9.
//
// Plain C ABI for ctypes; built with g++ by cednerf_torch/utils/host_build.py.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// raw: h rows of (1 + rowbytes) bytes, each a filter type then the row;
// out: h * rowbytes bytes; bpp: bytes per complete pixel (>= 1).
// Returns 0, or -(r + 1) when row r has a filter type outside 0-4.
int64_t cednerf_png_unfilter(const uint8_t* raw, int64_t h, int64_t rowbytes,
                             int64_t bpp, uint8_t* out) {
  const uint8_t* prior = nullptr;
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t ftype = raw[r * (rowbytes + 1)];
    const uint8_t* src = raw + r * (rowbytes + 1) + 1;
    uint8_t* row = out + r * rowbytes;
    switch (ftype) {
      case 0:
        for (int64_t i = 0; i < rowbytes; ++i) row[i] = src[i];
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          row[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? row[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          row[i] = static_cast<uint8_t>(src[i] + (prior ? prior[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          row[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
          row[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return -(r + 1);
    }
    prior = row;
  }
  return 0;
}

}  // extern "C"
