// Host routines of the image codec: the PNG unfilter (data/png.py), the
// two 8-bit passes of Pillow's LANCZOS resample (data/resample.py), the
// JPEG entropy decoding and pixel stage (data/jpeg.py) and the TIFF LZW
// decoder (data/tiff.py).
//
// Plain C++ with a C interface, compiled into the kernel library by the same
// nvcc call as the CUDA sources (nvcc hands a .cpp file to the host
// compiler) and loaded through ctypes. Integer code only, so each routine
// gives the same bytes as its numpy version on any compiler.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <vector>

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


// JPEG: the bits of one entropy-coded segment (unstuffed), read MSB first;
// bytes past its end read as zeros.
struct BitReader {
  const uint8_t* d;
  int64_t n;
  int64_t p = 0;  // bits consumed

  uint32_t byte(int64_t i) const { return i < n ? d[i] : 0; }
  uint32_t window() const {
    const int64_t i = p >> 3;
    return byte(i) << 24 | byte(i + 1) << 16 | byte(i + 2) << 8 |
           byte(i + 3);
  }
  // the symbol of the code at p through a 16-bit lookahead table (entries
  // length << 8 | symbol), -1 if no code starts there
  int symbol(const uint16_t* lut) {
    const int e = lut[(window() >> (16 - (p & 7))) & 0xFFFF];
    if (e == 0) return -1;
    p += e >> 8;
    return e & 255;
  }
  int bits(int s) {
    if (s == 0) return 0;
    const int v = (window() >> (32 - (p & 7) - s)) & ((1u << s) - 1);
    p += s;
    return v;
  }
};

// JPEG's sign extension of an s-bit magnitude category value.
inline int extend(int v, int s) {
  return s && v < (1 << (s - 1)) ? v + 1 - (1 << s) : v;
}

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct ScanComp {
  int h, v, bw, bh, cols;
  const uint16_t* dc;
  const uint16_t* ac;
  int16_t* co;
};

// One block of a scan (data/jpeg.py entropy_numpy, block by block): 0, or
// 2 on an undefined code, 3 on a coefficient past the band.
int decode_block(BitReader& br, const ScanComp& c, int16_t* co, int ss,
                 int se, int ah, int al, uint32_t& pred, int& eobrun) {
  const int p1 = 1 << al;
  const int m1 = -(1 << al);
  if (ss == 0) {
    if (ah == 0) {
      const int s = br.symbol(c.dc);
      if (s < 0) return 2;
      pred += static_cast<uint32_t>(extend(br.bits(s), s));
      co[0] = static_cast<int16_t>(static_cast<uint16_t>(pred << al));
    } else if (br.bits(1)) {
      co[0] = static_cast<int16_t>(co[0] | p1);
    }
    if (se == 0) return 0;
  }
  int k = std::max(ss, 1);
  if (ah == 0) {
    if (eobrun > 0) {
      --eobrun;
      return 0;
    }
    while (k <= se) {
      const int rs = br.symbol(c.ac);
      if (rs < 0) return 2;
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) return 3;
        const int v = extend(br.bits(s), s);
        co[kZigzag[k]] = static_cast<int16_t>(
            static_cast<uint16_t>(static_cast<uint32_t>(v) << al));
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        if (ss) {  // EOBr: 2^r blocks and r more bits
          eobrun = (1 << r) + br.bits(r) - 1;
        }
        break;
      }
    }
    return 0;
  }
  if (eobrun == 0) {
    while (k <= se) {
      const int rs = br.symbol(c.ac);
      if (rs < 0) return 2;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        if (s != 1) return 2;
        s = br.bits(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun = (1 << r) + br.bits(r);
        break;
      }
      // skip r zero-history coefficients, correcting the nonzero ones
      while (k <= se) {
        int16_t& cur = co[kZigzag[k]];
        if (cur) {
          if (br.bits(1) && !(cur & p1)) {
            cur = static_cast<int16_t>(cur + (cur >= 0 ? p1 : m1));
          }
        } else if (--r < 0) {
          break;
        }
        ++k;
      }
      if (s) {
        if (k > se) return 3;
        co[kZigzag[k]] = static_cast<int16_t>(s);
      }
      ++k;
    }
  }
  if (eobrun > 0) {
    for (; k <= se; ++k) {
      int16_t& cur = co[kZigzag[k]];
      if (cur && br.bits(1) && !(cur & p1)) {
        cur = static_cast<int16_t>(cur + (cur >= 0 ? p1 : m1));
      }
    }
    --eobrun;
  }
  return 0;
}

// jidctint.c's jpeg_idct_islow on one block: coefficients (natural order)
// times their quantisation values -> 8x8 samples at out (row stride
// ``stride``), the range limit taken mod 1024 as libjpeg's table does.
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995,
                  F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

inline void idct_1d(const int64_t* in, int step, int64_t* out, int ostep,
                    int shift) {
  int64_t z2 = in[2 * step], z3 = in[6 * step];
  int64_t z1 = (z2 + z3) * F0541;
  const int64_t tmp2 = z1 - z3 * F1847;
  const int64_t tmp3 = z1 + z2 * F0765;
  const int64_t e0 = (in[0] + in[4 * step]) * 8192;
  const int64_t e1 = (in[0] - in[4 * step]) * 8192;
  const int64_t tmp10 = e0 + tmp3, tmp13 = e0 - tmp3;
  const int64_t tmp11 = e1 + tmp2, tmp12 = e1 - tmp2;
  int64_t o0 = in[7 * step], o1 = in[5 * step], o2 = in[3 * step],
          o3 = in[step];
  z1 = o0 + o3;
  z2 = o1 + o2;
  z3 = o0 + o2;
  int64_t z4 = o1 + o3;
  const int64_t z5 = (z3 + z4) * F1175;
  o0 *= F0298;
  o1 *= F2053;
  o2 *= F3072;
  o3 *= F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  o0 += z1 + z3;
  o1 += z2 + z4;
  o2 += z2 + z3;
  o3 += z1 + z4;
  out[0] = descale(tmp10 + o3, shift);
  out[7 * ostep] = descale(tmp10 - o3, shift);
  out[ostep] = descale(tmp11 + o2, shift);
  out[6 * ostep] = descale(tmp11 - o2, shift);
  out[2 * ostep] = descale(tmp12 + o1, shift);
  out[5 * ostep] = descale(tmp12 - o1, shift);
  out[3 * ostep] = descale(tmp13 + o0, shift);
  out[4 * ostep] = descale(tmp13 - o0, shift);
}

void idct_block(const int16_t* coef, const int32_t* quant, uint8_t* out,
                int64_t stride) {
  int64_t x[64], ws[64], row[8];
  for (int i = 0; i < 64; ++i) {
    x[i] = static_cast<int64_t>(coef[i]) * quant[i];
  }
  for (int c = 0; c < 8; ++c) idct_1d(x + c, 8, ws + c, 8, 11);
  for (int r = 0; r < 8; ++r) {
    idct_1d(ws + 8 * r, 1, row, 1, 18);
    for (int c = 0; c < 8; ++c) {
      const int v = static_cast<int>(((row[c] + 512) & 1023) - 512) + 128;
      out[r * stride + c] = static_cast<uint8_t>(std::min(255,
                                                          std::max(0, v)));
    }
  }
}

inline uint8_t clamp8(int64_t v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// TIFF LZW (MSB first, 9-12 bit codes, the code width grows one code
// early): 0, or 1 on a code that is not yet defined. ``*written`` gets the
// bytes written (at most ``cap``; more are dropped, as libtiff does).
int lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap,
               int64_t* written) {
  std::vector<int32_t> prefix(4096), first(4096), length(4096);
  std::vector<uint8_t> last(4096);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    first[i] = i;
    length[i] = 1;
    last[i] = static_cast<uint8_t>(i);
  }
  int64_t pos = 0, o = 0;
  int next = 258, width = 9, prev = -1;
  std::vector<uint8_t> tmp(4096);
  while (pos + width <= n * 8) {
    int code = 0;
    for (int b = 0; b < width; ++b, ++pos) {
      code = code << 1 | ((in[pos >> 3] >> (7 - (pos & 7))) & 1);
    }
    if (code == 257) break;
    if (code == 256) {
      next = 258;
      width = 9;
      prev = -1;
      continue;
    }
    int entry;
    if (code < next && (code < 256 || code >= 258)) {
      entry = code;
    } else if (code == next && prev >= 0) {
      entry = -1;
    } else {
      *written = o;
      return 1;
    }
    if (prev >= 0 && next < 4096) {
      prefix[next] = prev;
      first[next] = first[prev];
      length[next] = length[prev] + 1;
      last[next] = static_cast<uint8_t>(first[entry < 0 ? prev : entry]);
      ++next;
    }
    if (entry < 0) entry = next - 1;
    // the entry's bytes, from its last back to its first
    const int len = length[entry];
    for (int i = len - 1, e = entry; i >= 0; --i, e = prefix[e]) {
      tmp[i] = last[e];
    }
    for (int i = 0; i < len && o < cap; ++i) out[o++] = tmp[i];
    prev = code == entry ? code : entry;
    if (next + 1 >= (1 << width) && width < 12) ++width;
  }
  *written = o;
  return 0;
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

// Decode one JPEG scan into the coefficient arrays (data/jpeg.py
// entropy_native). ``params``: components in the scan, Ss, Se, Ah, Al, MCU
// columns and rows, restart interval (0: none), segments; then per scan
// component h, v, blocks wide and high, grid columns, DC and AC table.
// ``seg`` holds the segments' byte offsets in ``data``; ``luts`` the 8
// lookahead tables (DC 0-3, AC 0-3). Returns 0, 1 if a segment's data runs
// out, 2 on an undefined code, 3 on a coefficient past the band, 4 if the
// segments do not match the MCUs.
int upe_jpeg_entropy(const uint8_t* data, const int64_t* seg,
                     const int32_t* params, int16_t* const* coefs,
                     const uint16_t* luts) {
  const int ns = params[0], ss = params[1], se = params[2], ah = params[3],
            al = params[4], mcux = params[5], mcuy = params[6];
  const int restart = params[7], nseg = params[8];
  ScanComp comp[4];
  int per_mcu = 0;
  for (int k = 0; k < ns; ++k) {
    const int32_t* q = params + 9 + 7 * k;
    comp[k] = {q[0], q[1], q[2], q[3], q[4], luts + int64_t{q[5]} * 65536,
               luts + int64_t{4 + q[6]} * 65536, coefs[k]};
    per_mcu += q[0] * q[1];
  }
  const int64_t n_mcu = ns == 1 ? int64_t{comp[0].bw} * comp[0].bh
                                : int64_t{mcux} * mcuy;
  const int64_t rst = restart ? restart : n_mcu;
  if (nseg != (n_mcu + rst - 1) / rst) return 4;
  BitReader br{nullptr, 0};
  uint32_t pred[4] = {0, 0, 0, 0};
  int eobrun = 0;
  for (int64_t m = 0; m < n_mcu; ++m) {
    if (m % rst == 0) {
      const int64_t s = m / rst;
      br = BitReader{data + seg[s], seg[s + 1] - seg[s]};
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
    }
    if (ns == 1) {
      const ScanComp& c = comp[0];
      const int64_t idx = (m / c.bw) * c.cols + m % c.bw;
      const int code = decode_block(br, c, c.co + idx * 64, ss, se, ah, al,
                                    pred[0], eobrun);
      if (code) return code;
    } else {
      const int64_t my = m / mcux, mx = m % mcux;
      for (int k = 0; k < ns; ++k) {
        const ScanComp& c = comp[k];
        for (int r = 0; r < c.v; ++r) {
          for (int q = 0; q < c.h; ++q) {
            const int64_t idx = (my * c.v + r) * c.cols + mx * c.h + q;
            const int code = decode_block(br, c, c.co + idx * 64, ss, se, ah,
                                          al, pred[k], eobrun);
            if (code) return code;
          }
        }
      }
    }
    if (br.p > br.n * 8) return 1;
  }
  return 0;
}

// The JPEG pixel stage (data/jpeg.py pixels_native): each component's
// blocks through the integer inverse DCT, upsampled to the frame (fancy 2x1
// and 2x2 over planes more than 2 samples wide, replication otherwise) and
// converted from YCbCr (or not: RGB, grey). ``params``: components, width,
// height, largest h and v, RGB flag; then per component h, v, sample width
// and height, grid columns. ``quant``: 64 values per component (natural
// order). ``out``: height x width x (1 or 3) bytes. Returns 0.
int upe_jpeg_pixels(int16_t* const* coefs, const int32_t* quant,
                    const int32_t* params, uint8_t* out) {
  const int n = params[0], width = params[1], height = params[2],
            hmax = params[3], vmax = params[4], rgb = params[5];
  std::vector<std::vector<uint8_t>> full(n);
  for (int k = 0; k < n; ++k) {
    const int32_t* q = params + 6 + 5 * k;
    const int h = q[0], v = q[1], cw = q[2], ch = q[3], cols = q[4];
    const int bw = (cw + 7) / 8, bh = (ch + 7) / 8;
    const int64_t stride = int64_t{bw} * 8;
    std::vector<uint8_t> plane(stride * bh * 8);
    for (int r = 0; r < bh; ++r) {
      for (int c = 0; c < bw; ++c) {
        idct_block(coefs[k] + (int64_t{r} * cols + c) * 64, quant + 64 * k,
                   plane.data() + int64_t{r} * 8 * stride + c * 8, stride);
      }
    }
    const int fh = hmax / h, fv = vmax / v;
    const bool fancy = fh == 2 && (fv == 1 || fv == 2) && cw > 2;
    std::vector<uint8_t>& up = full[k];
    up.resize(int64_t{width} * height);
    std::vector<int32_t> sums(cw);
    for (int y = 0; y < height; ++y) {
      uint8_t* dst = up.data() + int64_t{y} * width;
      const int i = y / fv;
      const uint8_t* src = plane.data() + int64_t{i} * stride;
      if (!fancy) {
        for (int x = 0; x < width; ++x) dst[x] = src[x / fh];
        continue;
      }
      if (fv == 1) {
        for (int x = 0; x < width; ++x) {
          const int j = x >> 1;
          if (x == 0) {
            dst[x] = src[0];
          } else if (x == 2 * cw - 1) {
            dst[x] = src[cw - 1];
          } else if (x & 1) {
            dst[x] = static_cast<uint8_t>((3 * src[j] + src[j + 1] + 2) >> 2);
          } else {
            dst[x] = static_cast<uint8_t>((3 * src[j] + src[j - 1] + 1) >> 2);
          }
        }
        continue;
      }
      const int nb = (y & 1) ? std::min(i + 1, ch - 1) : std::max(i - 1, 0);
      const uint8_t* other = plane.data() + int64_t{nb} * stride;
      for (int j = 0; j < cw; ++j) sums[j] = 3 * src[j] + other[j];
      for (int x = 0; x < width; ++x) {
        const int j = x >> 1;
        int val;
        if (x == 0) {
          val = (4 * sums[0] + 8) >> 4;
        } else if (x == 2 * cw - 1) {
          val = (4 * sums[cw - 1] + 7) >> 4;
        } else if (x & 1) {
          val = (3 * sums[j] + sums[j + 1] + 7) >> 4;
        } else {
          val = (3 * sums[j] + sums[j - 1] + 8) >> 4;
        }
        dst[x] = static_cast<uint8_t>(val);
      }
    }
  }
  const int64_t pixels = int64_t{width} * height;
  if (n == 1) {
    std::copy(full[0].begin(), full[0].end(), out);
    return 0;
  }
  if (rgb) {
    for (int64_t i = 0; i < pixels; ++i) {
      for (int k = 0; k < 3; ++k) out[3 * i + k] = full[k][i];
    }
    return 0;
  }
  // jdcolor.c's tables: FIX(x) = x * 2^16 rounded, ONE_HALF = 2^15
  int64_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = (91881 * x + 32768) >> 16;
    cb_b[i] = (116130 * x + 32768) >> 16;
    cr_g[i] = -46802 * x;
    cb_g[i] = -22554 * x + 32768;
  }
  for (int64_t i = 0; i < pixels; ++i) {
    const int64_t y = full[0][i];
    const int cb = full[1][i], cr = full[2][i];
    out[3 * i] = clamp8(y + cr_r[cr]);
    out[3 * i + 1] = clamp8(y + ((cb_g[cb] + cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp8(y + cb_b[cb]);
  }
  return 0;
}

// TIFF LZW: ``n`` bytes of one strip or tile into at most ``cap`` bytes at
// ``out``; the count written goes to ``*written``. Returns 0, or 1 on a
// code that is not yet defined (data/tiff.py lzw_numpy).
int upe_tiff_lzw(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap,
                 int64_t* written) {
  return lzw_decode(in, n, out, cap, written);
}

}  // extern "C"
