// Device helpers shared by the warp and reprojection-loss kernels.
//
// Arithmetic note: the library is compiled with -fmad=false and every
// expression below follows the operation order of the plain PyTorch
// versions in ops/kernels/*.py, so a kernel and its plain version round
// alike; floor() decisions on the warp coordinates then agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace upe {

// Output tile of the SSIM kernels: 32 x 8 pixels, one thread each, plus a
// one-pixel halo for the 3x3 window.
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloH = kTileH + 2;
constexpr int kHalo = kHaloW * kHaloH;

// Reflect padding by one pixel (row -1 = row 1, row n = row n - 2), then a
// clamp that only matters for halo pixels of a tile hanging past the image.
__device__ __forceinline__ int reflect_clamp(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// Bilinear taps of the warp at output pixel (i, j) of batch element b.
// image: (B, H, W, C) uint8; grid: (B, 2, H, W) float in [-1, 1],
// align_corners=True, border padding.
struct Taps {
  const uint8_t* p00;  // channel 0 of tap (y0, x0)
  int dx;              // bytes to tap (y0, x0 + 1)
  int dy;              // bytes to tap (y0 + 1, x0)
  float wx, wy;
};

__device__ __forceinline__ Taps warp_taps(const uint8_t* image,
                                          const float* grid, int b, int i,
                                          int j, int H, int W, int C) {
  const long long plane = (long long)H * W;
  const float gx = grid[(2LL * b) * plane + (long long)i * W + j];
  const float gy = grid[(2LL * b + 1) * plane + (long long)i * W + j];
  const float fw = (float)(W - 1), fh = (float)(H - 1);
  const float x = fminf(fmaxf((gx + 1.0f) * 0.5f * fw, 0.0f), fw);
  const float y = fminf(fmaxf((gy + 1.0f) * 0.5f * fh, 0.0f), fh);
  const float x0 = fminf(floorf(x), (float)(W - 2));
  const float y0 = fminf(floorf(y), (float)(H - 2));
  Taps t;
  t.p00 = image + (((long long)b * H + (int)y0) * W + (int)x0) * C;
  t.dx = C;
  t.dy = W * C;
  t.wx = x - x0;
  t.wy = y - y0;
  return t;
}

// Warped value of channel c, in [0, 1]: the lerp runs on raw 0..255 values
// (exact integers in float) and is scaled once at the end.
__device__ __forceinline__ void warp_channel(const Taps& t, int c,
                                             float* warped, float* ddx,
                                             float* ddy) {
  const float inv255 = 1.0f / 255.0f;
  const float v00 = (float)t.p00[c];
  const float v01 = (float)t.p00[t.dx + c];
  const float v10 = (float)t.p00[t.dy + c];
  const float v11 = (float)t.p00[t.dy + t.dx + c];
  const float dtop = v01 - v00;
  const float dbot = v11 - v10;
  const float top = v00 + t.wx * dtop;
  const float bot = v10 + t.wx * dbot;
  *warped = (top + t.wy * (bot - top)) * inv255;
  if (ddx != nullptr) {
    *ddx = (dtop + t.wy * (dbot - dtop)) * inv255;
    *ddy = (bot - top) * inv255;
  }
}

// 3x3 window mean of f(dy, dx) over a halo tile: rows first, then columns,
// the order of ops.losses._win3.
template <typename F>
__device__ __forceinline__ float win3(F f) {
  const float r0 = f(0, 0) + f(1, 0) + f(2, 0);
  const float r1 = f(0, 1) + f(1, 1) + f(2, 1);
  const float r2 = f(0, 2) + f(1, 2) + f(2, 2);
  return (r0 + r1 + r2) * (1.0f / 9.0f);
}

// Per-pixel 0.85 * clamp((1 - SSIM) / 2, 0, 1) + 0.15 * |t - p|, averaged
// over channels, for the thread's pixel (tx, ty) of a halo tile. sp / st
// hold C halo planes of kHalo floats each (prediction / target).
__device__ __forceinline__ float ssim_l1_score(const float* sp,
                                               const float* st, int C,
                                               int tx, int ty) {
  const float c1 = (float)(0.01 * 0.01);
  const float c2 = (float)(0.03 * 0.03);
  const float inv_c = 1.0f / (float)C;
  float acc = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float* p = sp + c * kHalo + ty * kHaloW + tx;
    const float* q = st + c * kHalo + ty * kHaloW + tx;
    auto at = [](const float* a, int dy, int dx) {
      return a[dy * kHaloW + dx];
    };
    const float mu_x = win3([&](int dy, int dx) { return at(p, dy, dx); });
    const float mu_y = win3([&](int dy, int dx) { return at(q, dy, dx); });
    const float sigma_x =
        win3([&](int dy, int dx) { return at(p, dy, dx) * at(p, dy, dx); }) -
        mu_x * mu_x;
    const float sigma_y =
        win3([&](int dy, int dx) { return at(q, dy, dx) * at(q, dy, dx); }) -
        mu_y * mu_y;
    const float sigma_xy =
        win3([&](int dy, int dx) { return at(p, dy, dx) * at(q, dy, dx); }) -
        mu_x * mu_y;
    const float ssim_n = (2.0f * mu_x * mu_y + c1) * (2.0f * sigma_xy + c2);
    const float ssim_d =
        (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2);
    const float dssim = fminf(fmaxf((1.0f - ssim_n / ssim_d) * 0.5f, 0.0f),
                              1.0f);
    const float l1 = fabsf(at(q, 1, 1) - at(p, 1, 1));
    acc = acc + (0.85f * dssim + 0.15f * l1) * inv_c;
  }
  return acc;
}

}  // namespace upe
