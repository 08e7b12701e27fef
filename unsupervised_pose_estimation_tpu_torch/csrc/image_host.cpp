// Host routines of the image codec: the PNG unfilter (data/png.py) and the
// two 8-bit passes of Pillow's LANCZOS resample (data/resample.py).
//
// Plain C++ with a C interface, compiled into the kernel library by the same
// nvcc call as the CUDA sources (nvcc hands a .cpp file to the host
// compiler) and loaded through ctypes. Integer code only, so each routine
// gives the same bytes as its numpy version on any compiler.

#include <cstdint>
#include <cstdlib>

namespace {

inline int paeth(int a, int b, int c) {
  int pa = std::abs(b - c);
  int pb = std::abs(a - c);
  int pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Pillow's clip8: the sum carries 22 fraction bits.
constexpr int kPrecisionBits = 22;

inline uint8_t clip8(int32_t v) {
  if (v >= (1 << kPrecisionBits << 8)) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

}  // namespace

extern "C" {

// Reverse the PNG filters of ``rows`` scanlines. ``raw`` holds each line's
// filter-type byte followed by ``stride`` filtered bytes; ``out`` receives
// rows * stride bytes. ``bpp`` is the bytes per complete pixel. Returns 0,
// or 1 + the index of the first line whose filter type is not 0-4.
int upe_png_unfilter(const uint8_t* raw, int rows, int stride, int bpp,
                     uint8_t* out) {
  for (int r = 0; r < rows; ++r) {
    const uint8_t* line = raw + static_cast<int64_t>(r) * (stride + 1);
    const int type = line[0];
    const uint8_t* src = line + 1;
    uint8_t* cur = out + static_cast<int64_t>(r) * stride;
    const uint8_t* prev = r > 0 ? cur - stride : nullptr;
    for (int i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return r + 1;
      }
      cur[i] = static_cast<uint8_t>(src[i] + pred);
    }
  }
  return 0;
}

// The horizontal pass: rows row0 .. row0 + rows - 1 of ``in`` (in_w pixels
// of ``channels`` bytes a row) into ``out`` (rows x out_w pixels). Output
// column x sums bounds[2x + 1] taps from input column bounds[2x], weighted
// by kk[x * ksize ...] (22 fraction bits). Returns 0.
int upe_resample_horizontal_u8(const uint8_t* in, int in_w, int channels,
                               int row0, int rows, uint8_t* out, int out_w,
                               const int32_t* bounds, const int32_t* kk,
                               int ksize) {
  for (int y = 0; y < rows; ++y) {
    const uint8_t* src =
        in + static_cast<int64_t>(row0 + y) * in_w * channels;
    uint8_t* dst = out + static_cast<int64_t>(y) * out_w * channels;
    for (int x = 0; x < out_w; ++x) {
      const int xmin = bounds[2 * x];
      const int xn = bounds[2 * x + 1];
      const int32_t* k = kk + static_cast<int64_t>(x) * ksize;
      for (int ch = 0; ch < channels; ++ch) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int t = 0; t < xn; ++t) {
          ss += static_cast<int32_t>(src[(xmin + t) * channels + ch]) * k[t];
        }
        dst[x * channels + ch] = clip8(ss);
      }
    }
  }
  return 0;
}

// The vertical pass: ``in`` (width pixels of ``channels`` bytes a row) into
// ``out`` (out_h rows). Output row y sums bounds[2y + 1] rows from input row
// bounds[2y], weighted by kk[y * ksize ...]; the sums run row by row
// through ``acc`` (width * channels int32 of scratch). Returns 0.
int upe_resample_vertical_u8(const uint8_t* in, int width, int channels,
                             uint8_t* out, int out_h, const int32_t* bounds,
                             const int32_t* kk, int ksize, int32_t* acc) {
  const int64_t row = static_cast<int64_t>(width) * channels;
  for (int y = 0; y < out_h; ++y) {
    const int ymin = bounds[2 * y];
    const int yn = bounds[2 * y + 1];
    const int32_t* k = kk + static_cast<int64_t>(y) * ksize;
    for (int64_t i = 0; i < row; ++i) acc[i] = 1 << (kPrecisionBits - 1);
    for (int t = 0; t < yn; ++t) {
      const uint8_t* src = in + (ymin + t) * row;
      const int32_t w = k[t];
      for (int64_t i = 0; i < row; ++i) {
        acc[i] += static_cast<int32_t>(src[i]) * w;
      }
    }
    uint8_t* dst = out + y * row;
    for (int64_t i = 0; i < row; ++i) dst[i] = clip8(acc[i]);
  }
  return 0;
}

}  // extern "C"
