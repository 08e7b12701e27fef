// Device helpers shared by the warp and reprojection-loss kernels, forward
// (K1, K3, K5) and backward (K2, K4).
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

// ---------------------------------------------------------------------
// Backward of the SSIM + L1 score (K2, K4)
//
// The loss at pixel i reads the 3x3 reflect-padded window moments of the
// prediction p and target t around i. Its adjoint wrt p is
//
//   dL/dp = k_l1 * g * sign(p - t)
//         + A(c_mu_p) + 2 p * A(c_sq) + t * A(c_pt)        (and likewise t)
//
// where the c_* planes are the derivatives of the SSIM term wrt the window
// means mu_p, mu_t, W(p^2) / W(t^2) and W(p t) at every pixel, and A is the
// adjoint of the reflect-padded 3x3 mean: a zero-padded 3x3 sum plus, from
// the two edge windows that read a reflected row/column, a second deposit
// on rows/columns 1 and n-2. So an output pixel needs the c_* planes on a
// one-pixel halo, and those need p and t on a two-pixel halo. A block owns
// a kTileW x kTileH output tile: it stages p and t of one channel with the
// two-pixel reflect halo, computes the c_* planes on the one-pixel halo
// (zero outside the image, which makes A's zero padding), then each thread
// applies A at its own pixel. The arithmetic follows the plain versions in
// ops/kernels/reproj_loss.py (ssim_l1_grads_plain) step for step.

constexpr int kHalo2W = kTileW + 4;
constexpr int kHalo2H = kTileH + 4;
constexpr int kHalo2 = kHalo2W * kHalo2H;

struct BwdSmem {
  float p[kHalo2];   // prediction (warped), two-pixel reflect halo
  float t[kHalo2];   // target, two-pixel reflect halo
  float g[kHalo];    // upstream gradient (B, H, W) on the one-pixel halo
  float mu_p[kHalo];  // c_mu_p on the one-pixel halo
  float mu_t[kHalo];  // c_mu_t
  float sq[kHalo];    // c_sq
  float pt[kHalo];    // c_pt
};

// Stage g of batch element b on the one-pixel halo, zero outside the image.
__device__ __forceinline__ void stage_grad(BwdSmem& sm, const float* g, int b,
                                           int oy, int ox, int H, int W) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const long long plane = (long long)H * W;
  for (int k = tid; k < kHalo; k += blockDim.x * blockDim.y) {
    const int i = oy + k / kHaloW;
    const int j = ox + k % kHaloW;
    sm.g[k] = (i >= 0 && i < H && j >= 0 && j < W)
                  ? g[(long long)b * plane + (long long)i * W + j]
                  : 0.0f;
  }
}

// Adjoint A of the reflect-padded 3x3 mean at image pixel (i, j), whose
// coefficient plane c sits at halo coordinates (ty + 1, tx + 1): columns
// first, then rows, as the plain version.
__device__ __forceinline__ float adj3(const float* c, int tx, int ty, int i,
                                      int j, int H, int W) {
  float s[3];
  for (int dy = 0; dy < 3; ++dy) {
    const float* r = c + (ty + dy) * kHaloW + tx;  // columns j-1, j, j+1
    float v = r[1] + r[0] + r[2];
    if (j == 1) v = v + r[0];
    if (j == W - 2) v = v + r[2];
    s[dy] = v;
  }
  float out = s[0] + s[1] + s[2];
  if (i == 1) out = out + s[0];
  if (i == H - 2) out = out + s[2];
  return out * (1.0f / 9.0f);
}

// One channel of the SSIM + L1 adjoint for the thread's pixel (i, j) of
// batch element b: stages the channel's planes, builds the c_* planes,
// and returns dL/dp (and dL/dt in *gt when gt is not null). k_ssim =
// 0.85 / C and k_l1 = 0.15 / C. Every thread of the block must call it;
// it ends with the block synchronised and the shared planes free.
__device__ __forceinline__ float ssim_l1_grad_channel(
    BwdSmem& sm, const float* pred, const float* target, long long base,
    int oy, int ox, int i, int j, int H, int W, float k_ssim, float k_l1,
    float* gt) {
  const float c1 = (float)(0.01 * 0.01);
  const float c2 = (float)(0.03 * 0.03);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int k = tid; k < kHalo2; k += nthreads) {
    const int y = reflect_clamp(oy - 1 + k / kHalo2W, H);
    const int x = reflect_clamp(ox - 1 + k % kHalo2W, W);
    const long long o = base + (long long)y * W + x;
    sm.p[k] = pred[o];
    sm.t[k] = target[o];
  }
  __syncthreads();
  for (int k = tid; k < kHalo; k += nthreads) {
    const int hy = k / kHaloW, hx = k % kHaloW;
    const int y = oy + hy, x = ox + hx;
    float c_mu_p = 0.0f, c_mu_t = 0.0f, c_sq = 0.0f, c_pt = 0.0f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float* p = sm.p + hy * kHalo2W + hx;
      const float* q = sm.t + hy * kHalo2W + hx;
      auto at = [](const float* a, int dy, int dx) {
        return a[dy * kHalo2W + dx];
      };
      const float mu_p = win3([&](int dy, int dx) { return at(p, dy, dx); });
      const float mu_t = win3([&](int dy, int dx) { return at(q, dy, dx); });
      const float wp2 =
          win3([&](int dy, int dx) { return at(p, dy, dx) * at(p, dy, dx); });
      const float wt2 =
          win3([&](int dy, int dx) { return at(q, dy, dx) * at(q, dy, dx); });
      const float wpt =
          win3([&](int dy, int dx) { return at(p, dy, dx) * at(q, dy, dx); });
      const float sigma_p = wp2 - mu_p * mu_p;
      const float sigma_t = wt2 - mu_t * mu_t;
      const float sigma_pt = wpt - mu_p * mu_t;
      const float n1 = 2.0f * mu_p * mu_t + c1;
      const float n2 = 2.0f * sigma_pt + c2;
      const float d1 = mu_p * mu_p + mu_t * mu_t + c1;
      const float d2 = sigma_p + sigma_t + c2;
      const float nn = n1 * n2;
      const float dd = d1 * d2;
      const float raw = (1.0f - nn / dd) * 0.5f;
      // clip's gradient: the SSIM term is dead where it is clamped
      const float gl = (raw > 0.0f && raw < 1.0f) ? sm.g[k] * k_ssim : 0.0f;
      const float inv_dd = 1.0f / dd;
      const float dl_dn = (-0.5f * gl) * inv_dd;
      const float dl_dd = (((0.5f * gl) * nn) * inv_dd) * inv_dd;
      c_mu_p = ((dl_dn * 2.0f) * mu_t) * (n2 - n1) +
               ((dl_dd * 2.0f) * mu_p) * (d2 - d1);
      c_mu_t = ((dl_dn * 2.0f) * mu_p) * (n2 - n1) +
               ((dl_dd * 2.0f) * mu_t) * (d2 - d1);
      c_sq = dl_dd * d1;
      c_pt = (dl_dn * 2.0f) * n1;
    }
    sm.mu_p[k] = c_mu_p;
    sm.mu_t[k] = c_mu_t;
    sm.sq[k] = c_sq;
    sm.pt[k] = c_pt;
  }
  __syncthreads();
  float gp = 0.0f;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (i < H && j < W) {
    const float p = sm.p[(ty + 2) * kHalo2W + tx + 2];
    const float t = sm.t[(ty + 2) * kHalo2W + tx + 2];
    const float d = p - t;
    const float sgn = (float)((d > 0.0f) - (d < 0.0f));
    const float l1g = (k_l1 * sm.g[(ty + 1) * kHaloW + tx + 1]) * sgn;
    const float a_sq = adj3(sm.sq, tx, ty, i, j, H, W);
    const float a_pt = adj3(sm.pt, tx, ty, i, j, H, W);
    gp = ((l1g + adj3(sm.mu_p, tx, ty, i, j, H, W)) + (2.0f * p) * a_sq) +
         t * a_pt;
    if (gt != nullptr) {
      *gt = ((-l1g + adj3(sm.mu_t, tx, ty, i, j, H, W)) + (2.0f * t) * a_sq) +
            p * a_pt;
    }
  }
  __syncthreads();
  return gp;
}

}  // namespace upe
