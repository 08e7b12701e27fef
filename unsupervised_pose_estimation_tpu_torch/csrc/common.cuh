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

// Tile of the per-pixel kernels (K5 and the corner fetches of corners.cu):
// 32 x 8 pixels, one thread each.
constexpr int kTileW = 32;
constexpr int kTileH = 8;

// Let a kernel take `bytes` of dynamic shared memory: above 48 KB only
// once the function's attribute allows it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Reflect padding by one pixel (row -1 = row 1, row n = row n - 2), then a
// clamp that only matters for halo pixels of a tile hanging past the image.
__device__ __forceinline__ int reflect_clamp(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// Exact conversions between small non-negative integers and float without
// a conversion instruction (those issue at 1/8 of the float32 rate on
// sm_90): 2^23 + v holds v in its low mantissa bits, for 0 <= v < 2^23.
__device__ __forceinline__ float byte_to_float(uint8_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

__device__ __forceinline__ int whole_float_to_int(float v) {
  return __float_as_int(v + 8388608.0f) - 0x4B000000;
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
  t.p00 = image + (((long long)b * H + whole_float_to_int(y0)) * W +
                    whole_float_to_int(x0)) *
                       C;
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
  const float v00 = byte_to_float(t.p00[c]);
  const float v01 = byte_to_float(t.p00[t.dx + c]);
  const float v10 = byte_to_float(t.p00[t.dy + c]);
  const float v11 = byte_to_float(t.p00[t.dy + t.dx + c]);
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

// 0.85 * clamp((1 - SSIM) / 2, 0, 1) + 0.15 * l1 of one channel at one
// pixel, from its 3x3 window means of p, q, p^2, q^2 and p q.
__device__ __forceinline__ float dssim_l1(float mu_x, float mu_y, float w_xx,
                                          float w_yy, float w_xy, float l1) {
  const float c1 = (float)(0.01 * 0.01);
  const float c2 = (float)(0.03 * 0.03);
  const float sigma_x = w_xx - mu_x * mu_x;
  const float sigma_y = w_yy - mu_y * mu_y;
  const float sigma_xy = w_xy - mu_x * mu_y;
  const float ssim_n = (2.0f * mu_x * mu_y + c1) * (2.0f * sigma_xy + c2);
  const float ssim_d =
      (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2);
  const float dssim = fminf(fmaxf((1.0f - ssim_n / ssim_d) * 0.5f, 0.0f),
                            1.0f);
  return 0.85f * dssim + 0.15f * l1;
}

// ---------------------------------------------------------------------
// The tall tile of the SSIM/L1 kernels (K1-K4)
//
// A block of 32 x 8 threads owns a 32 x 16 output tile: thread (tx, ty)
// owns the pixels of column tx in tile rows 2 ty and 2 ty + 1, whose 3x3
// windows share two rows. Against a 32 x 8 tile, the halo costs 1.41x the
// tile's positions at two pixels (720 / 512, was 432 / 256) and 1.20x at
// one pixel (612 / 512, was 340 / 256). Halo tiles are walked in 2-D
// (for_each_halo): each warp takes whole rows of the 32 interior columns,
// whose loads are one aligned segment per row, and the 2R side columns go
// to the threads from the last one down, whose warps have the fewest rows.

constexpr int kTallW = 32;
constexpr int kTallH = 16;
constexpr int kTallWarps = 8;  // blockDim = (kTallW, kTallWarps)

// f(hy, hx) once for each position of a ROWS x (kTallW + 2R) halo tile.
template <int R, int ROWS, typename F>
__device__ __forceinline__ void for_each_halo(F f) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  for (int hy = warp; hy < ROWS; hy += kTallWarps) f(hy, R + lane);
  constexpr int n = kTallW * kTallWarps;
  for (int k = n - 1 - (warp * kTallW + lane); k < ROWS * 2 * R; k += n) {
    const int s = k % (2 * R);
    f(k / (2 * R), s < R ? s : kTallW + s);
  }
}

// Stage C planes of a planar float image (B, C, H, W), batch element b, on
// a ROWS x (kTallW + 2R) reflect-padded halo tile whose row 0 is image row
// oy and whose interior columns start at image column ox: one float per
// position.
template <int C, int R, int ROWS>
__device__ __forceinline__ void stage_planes(float* dst, const float* src,
                                             int b, int oy, int ox, int H,
                                             int W) {
  constexpr int HW = kTallW + 2 * R;
  const long long plane = (long long)H * W;
  const float* base = src + (long long)b * C * plane;
  for_each_halo<R, ROWS>([&](int hy, int hx) {
    const int y = reflect_clamp(oy + hy, H);
    const int x = reflect_clamp(ox - R + hx, W);
    const float* s = base + (long long)y * W + x;
    for (int c = 0; c < C; ++c) dst[(c * ROWS + hy) * HW + hx] = s[c * plane];
  });
}

// stage_planes for a tile whose interior lies inside the image, with rows
// 16-byte aligned: the interior read as float4s, the side columns as
// floats, held in registers between load() and store() so that a kernel
// can issue these loads before other work and store them after it.
template <int C, int R, int ROWS>
struct PlanePrefetch {
  static constexpr int HW = kTallW + 2 * R;
  static constexpr int n = kTallW * kTallWarps;
  static constexpr int V = kTallW / 4;      // float4s per interior row
  static constexpr int NV = C * ROWS * V;   // float4s per tile
  static constexpr int NS = C * ROWS * 2 * R;  // side floats per tile
  float4 v[(NV + n - 1) / n];
  float s[(NS + n - 1) / n];

  __device__ __forceinline__ void load(const float* src, int b, int oy,
                                       int ox, int H, int W) {
    const long long plane = (long long)H * W;
    const float* base = src + (long long)b * C * plane;
    const int tid = threadIdx.y * kTallW + threadIdx.x;
#pragma unroll
    for (int m = 0; m < (NV + n - 1) / n; ++m) {
      const int k = tid + m * n;
      if (k < NV) {
        const int c = k / (V * ROWS), r = (k / V) % ROWS;
        const int y = reflect_clamp(oy + r, H);
        v[m] = __ldg(reinterpret_cast<const float4*>(
                         base + c * plane + (long long)y * W + ox) +
                     k % V);
      }
    }
#pragma unroll
    for (int m = 0; m < (NS + n - 1) / n; ++m) {
      const int k = tid + m * n;
      if (k < NS) {
        const int c = k / (2 * R * ROWS), r = (k / (2 * R)) % ROWS;
        const int sc = k % (2 * R);
        const int y = reflect_clamp(oy + r, H);
        const int x = reflect_clamp(ox - R + (sc < R ? sc : kTallW + sc), W);
        s[m] = base[c * plane + (long long)y * W + x];
      }
    }
  }

  __device__ __forceinline__ void store(float* dst) const {
    const int tid = threadIdx.y * kTallW + threadIdx.x;
#pragma unroll
    for (int m = 0; m < (NV + n - 1) / n; ++m) {
      const int k = tid + m * n;
      if (k < NV) {
        const int c = k / (V * ROWS), r = (k / V) % ROWS;
        float* d = dst + (c * ROWS + r) * HW + R + 4 * (k % V);
        d[0] = v[m].x;
        d[1] = v[m].y;
        d[2] = v[m].z;
        d[3] = v[m].w;
      }
    }
#pragma unroll
    for (int m = 0; m < (NS + n - 1) / n; ++m) {
      const int k = tid + m * n;
      if (k < NS) {
        const int c = k / (2 * R * ROWS), r = (k / (2 * R)) % ROWS;
        const int sc = k % (2 * R);
        dst[(c * ROWS + r) * HW + (sc < R ? sc : kTallW + sc)] = s[m];
      }
    }
  }
};

// Warp batch element b of the uint8 frame onto a ROWS x (kTallW + 2R)
// reflect-padded halo tile (C planes), as stage_planes places its planes.
template <int C, int R, int ROWS>
__device__ __forceinline__ void stage_warp(float* dst, const uint8_t* image,
                                           const float* grid, int b, int oy,
                                           int ox, int H, int W) {
  constexpr int HW = kTallW + 2 * R;
  for_each_halo<R, ROWS>([&](int hy, int hx) {
    const int y = reflect_clamp(oy + hy, H);
    const int x = reflect_clamp(ox - R + hx, W);
    const Taps t = warp_taps(image, grid, b, y, x, H, W, C);
    for (int c = 0; c < C; ++c) {
      warp_channel(t, c, dst + (c * ROWS + hy) * HW + hx, nullptr, nullptr);
    }
  });
}

// Stage a fused kernel's tiles: the warped frame (stage_warp) and the
// target (stage_planes). On an interior tile with aligned rows (vec) the
// target's loads are issued first and stored after the warp, so the two
// phases' memory latencies overlap.
template <int C, int R, int ROWS>
__device__ __forceinline__ void stage_warp_and_target(
    float* warped, float* tgt, const uint8_t* image, const float* grid,
    const float* target, int b, int oy, int ox, int H, int W, bool vec) {
  if (vec && ox + kTallW <= W) {
    PlanePrefetch<C, R, ROWS> pre;
    pre.load(target, b, oy, ox, H, W);
    stage_warp<C, R, ROWS>(warped, image, grid, b, oy, ox, H, W);
    pre.store(tgt);
  } else {
    stage_warp<C, R, ROWS>(warped, image, grid, b, oy, ox, H, W);
    stage_planes<C, R, ROWS>(tgt, target, b, oy, ox, H, W);
  }
}

// The window sums of p, q, p^2, q^2 and p q (m[n][0..4]) of N vertically
// consecutive 3x3 windows, the first with its top-left at p / q in planes
// with rows of S floats, in the order of ops.losses._win3: each column
// summed top to bottom, the columns left to right. The N + 2 rows they
// span are read once per column and their products formed once.
template <int N, int S>
__device__ __forceinline__ void window_sums(const float* p, const float* q,
                                            float (&m)[N][5]) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float x[N + 2], y[N + 2], xx[N + 2], yy[N + 2], xy[N + 2];
#pragma unroll
    for (int k = 0; k < N + 2; ++k) {
      x[k] = p[k * S + dx];
      y[k] = q[k * S + dx];
      xx[k] = x[k] * x[k];
      yy[k] = y[k] * y[k];
      xy[k] = x[k] * y[k];
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float col[5] = {x[n] + x[n + 1] + x[n + 2],
                            y[n] + y[n + 1] + y[n + 2],
                            xx[n] + xx[n + 1] + xx[n + 2],
                            yy[n] + yy[n + 1] + yy[n + 2],
                            xy[n] + xy[n + 1] + xy[n + 2]};
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        m[n][v] = dx == 0 ? col[v] : m[n][v] + col[v];
      }
    }
  }
}

// Per-pixel 0.85 * clamp((1 - SSIM) / 2, 0, 1) + 0.15 * |t - p|, averaged
// over channels in channel order, of two vertically adjacent pixels: column
// tx of tile rows ty and ty + 1, from C one-pixel halo planes of the tall
// tile (ROWS x (kTallW + 2)) of the prediction (sp) and target (st).
template <int C, int ROWS>
__device__ __forceinline__ void ssim_l1_score_pair(const float* sp,
                                                   const float* st, int tx,
                                                   int ty, float* a,
                                                   float* b) {
  constexpr int S = kTallW + 2;
  const float inv_c = 1.0f / (float)C;
  const float ninth = 1.0f / 9.0f;
  float acc[2] = {0.0f, 0.0f};
  for (int c = 0; c < C; ++c) {
    const float* p = sp + (c * ROWS + ty) * S + tx;
    const float* q = st + (c * ROWS + ty) * S + tx;
    float m[2][5];
    window_sums<2, S>(p, q, m);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float l1 = fabsf(q[(n + 1) * S + 1] - p[(n + 1) * S + 1]);
      acc[n] = acc[n] + dssim_l1(m[n][0] * ninth, m[n][1] * ninth,
                                 m[n][2] * ninth, m[n][3] * ninth,
                                 m[n][4] * ninth, l1) *
                            inv_c;
    }
  }
  *a = acc[0];
  *b = acc[1];
}

// ---------------------------------------------------------------------
// Backward of the SSIM + L1 score on the tall tile (K2, K4)
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
// one-pixel halo, and those need p and t on a two-pixel halo. A block of
// the tall tile stages p and t of every channel on the two-pixel reflect
// halo (kRows2 x kCols2), forms the c_* planes of every channel on the
// one-pixel halo (kRows1 x kCols1; zero outside the image, which makes A's
// zero padding), three positions of a column per thread (coef_planes), and
// then applies A at two vertically adjacent pixels per thread (adj3_pair):
// two barriers per block. Where the target needs no cotangent (K2, and K4
// without it) there are three c_* planes per channel, no c_mu_t. The
// arithmetic follows ssim_l1_grads_plain in ops/kernels/reproj_loss.py
// step for step.

constexpr int kRows2 = kTallH + 4;  // two-pixel halo
constexpr int kCols2 = kTallW + 4;
constexpr int kHalo2 = kRows2 * kCols2;
constexpr int kRows1 = kTallH + 2;  // one-pixel halo
constexpr int kCols1 = kTallW + 2;
constexpr int kHalo1 = kRows1 * kCols1;

// The derivatives of the SSIM term of one channel at one pixel wrt its
// window means of p, t (c_mu_p, c_mu_t), of p^2 and t^2 (c_sq, shared) and
// of p t (c_pt), for upstream gradient g, from those five means: zero where
// the clamp of the SSIM term is active.
struct SsimCoefs {
  float mu_p, mu_t, sq, pt;
};

__device__ __forceinline__ SsimCoefs ssim_coefs_of_means(
    float mu_p, float mu_t, float wp2, float wt2, float wpt, float g,
    float k_ssim) {
  const float c1 = (float)(0.01 * 0.01);
  const float c2 = (float)(0.03 * 0.03);
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
  const float gl = (raw > 0.0f && raw < 1.0f) ? g * k_ssim : 0.0f;
  const float inv_dd = 1.0f / dd;
  const float dl_dn = (-0.5f * gl) * inv_dd;
  const float dl_dd = (((0.5f * gl) * nn) * inv_dd) * inv_dd;
  SsimCoefs cf;
  cf.mu_p = ((dl_dn * 2.0f) * mu_t) * (n2 - n1) +
            ((dl_dd * 2.0f) * mu_p) * (d2 - d1);
  cf.mu_t = ((dl_dn * 2.0f) * mu_p) * (n2 - n1) +
            ((dl_dd * 2.0f) * mu_t) * (d2 - d1);
  cf.sq = dl_dd * d1;
  cf.pt = (dl_dn * 2.0f) * n1;
  return cf;
}

// The coefficient planes of three vertically consecutive one-pixel-halo
// positions (hy0 .. hy0 + 2, hx) of every channel, from window_sums of the
// two-pixel-halo planes sp, st (C planes each) of the tile whose first
// image row and column are y0, x0: NP planes of C * kHalo1 floats each at
// cf, c_mu_p, c_sq, c_pt and, for NP = 4, c_mu_t; zero outside the image.
// g_at(y, x) is the upstream gradient at image pixel (y, x).
template <int C, int NP, typename G>
__device__ __forceinline__ void coef_column(const float* sp, const float* st,
                                            float* cf, G g_at, int y0,
                                            int x0, int hy0, int hx, int H,
                                            int W, float k_ssim) {
  constexpr int N = 3;
  constexpr int nc = C * kHalo1;
  const int x = x0 - 1 + hx;
  const float ninth = 1.0f / 9.0f;
  bool in[N];
  float gv[N];
  for (int n = 0; n < N; ++n) {
    const int y = y0 - 1 + hy0 + n;
    in[n] = y >= 0 && y < H && x >= 0 && x < W;
    gv[n] = in[n] ? g_at(y, x) : 0.0f;
  }
  for (int c = 0; c < C; ++c) {
    const int o2 = c * kHalo2 + hy0 * kCols2 + hx;
    float m[N][5];
    window_sums<N, kCols2>(sp + o2, st + o2, m);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      SsimCoefs k = {0.0f, 0.0f, 0.0f, 0.0f};
      if (in[n]) {
        k = ssim_coefs_of_means(m[n][0] * ninth, m[n][1] * ninth,
                                m[n][2] * ninth, m[n][3] * ninth,
                                m[n][4] * ninth, gv[n], k_ssim);
      }
      const int o = c * kHalo1 + (hy0 + n) * kCols1 + hx;
      cf[o] = k.mu_p;
      cf[nc + o] = k.sq;
      cf[2 * nc + o] = k.pt;
      if (NP == 4) cf[3 * nc + o] = k.mu_t;
    }
  }
}

// The NP coefficient planes of coef_column on the whole one-pixel halo,
// three positions of a column per thread: warps 0-5 take the 32 interior
// columns, twelve threads of warp 6 the two side columns. Every thread of
// the block calls it.
template <int C, int NP, typename G>
__device__ __forceinline__ void coef_planes(const float* sp, const float* st,
                                            float* cf, G g_at, int y0,
                                            int x0, int H, int W,
                                            float k_ssim) {
  constexpr int kTriples = kRows1 / 3;
  static_assert(kRows1 % 3 == 0 && kTriples < kTallWarps, "tile");
  const int lane = threadIdx.x, warp = threadIdx.y;
  if (warp < kTriples) {
    coef_column<C, NP>(sp, st, cf, g_at, y0, x0, 3 * warp, 1 + lane, H, W,
                       k_ssim);
  } else if (warp == kTriples && lane < 2 * kTriples) {
    coef_column<C, NP>(sp, st, cf, g_at, y0, x0, 3 * (lane / 2),
                       lane % 2 ? kCols1 - 1 : 0, H, W, k_ssim);
  }
}

// The adjoint A of the reflect-padded 3x3 mean at two vertically adjacent
// image pixels (i, j) and (i + 1, j), from a coefficient plane c with rows
// of S floats in which (i, j) sits at (ty + 1, tx + 1): each row's three
// columns summed (centre, left, right) with the second deposit on columns
// 1 and W - 2, then three rows top to bottom with the deposit on rows 1 and
// H - 2, times 1/9, as ops/kernels/reproj_loss.py _adj3; the row sums of
// the two middle rows serve both pixels.
template <int S>
__device__ __forceinline__ void adj3_pair(const float* c, int tx, int ty,
                                          int i, int j, int H, int W,
                                          float* a, float* b) {
  float s[4];
  for (int dy = 0; dy < 4; ++dy) {
    const float* r = c + (ty + dy) * S + tx;
    float v = r[1] + r[0] + r[2];
    if (j == 1) v = v + r[0];
    if (j == W - 2) v = v + r[2];
    s[dy] = v;
  }
  float oa = s[0] + s[1] + s[2];
  if (i == 1) oa = oa + s[0];
  if (i == H - 2) oa = oa + s[2];
  float ob = s[1] + s[2] + s[3];
  if (i + 1 == 1) ob = ob + s[1];
  if (i + 1 == H - 2) ob = ob + s[3];
  *a = oa * (1.0f / 9.0f);
  *b = ob * (1.0f / 9.0f);
}

}  // namespace upe
