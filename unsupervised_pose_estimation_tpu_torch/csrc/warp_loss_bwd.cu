// K2: backward of the fused warp + SSIM/L1 loss (K1) wrt the warp's
// pixel coordinates.
//
// Replaces unsupervised_pose_estimation_tpu/ops/pallas/warp_loss.py
// _bwd_kernel (launched by _warp_loss_bwd_call). The TPU kernel reads the
// forward's saved warped, d warped/dx and d warped/dy planes, holds one
// (batch, channel) plane per grid step and accumulates the two coordinate
// cotangents across the sequential channel axis of its grid. Here a block
// owns a 32 x 16 output tile and all C channels of it, so gx and gy are
// written once, with no atomics, and it rebuilds the warp from the uint8
// frame and the grid (upe::warp_taps, upe::warp_channel: the values K1's
// plain version makes, bit for bit) instead of reading saved planes. The
// target's cotangent is not formed: targets are input frames.
//
// Bound on an H100 SXM: bytes. Per pixel it reads C source bytes, 8 grid
// bytes, 4 * C target bytes and the upstream gradient, and writes two
// floats: at B=12, C=3, 192x640 that is 51.6 MB, 15.4 us at 3.35 TB/s
// (about 514 float operations per pixel, 11.3 us at 67 TFLOP/s).
//
// Design against that bound (common.cuh, the tall tile). The work per
// pixel, not the bytes, sets its time: the SSIM adjoint's window sums and
// coefficients are formed on a halo, and shared memory carries every
// operand. One pass stages the warped frame and the target of every
// channel on the two-pixel reflect halo (720 positions for 512 pixels),
// one pass forms the adjoint's coefficient planes of every channel on the
// one-pixel halo (612 positions; three planes, as the target needs no
// c_mu_t), each thread three positions of a column so the window rows
// they share are read once; then each thread applies the adjoint at two
// vertically adjacent pixels (their middle row sums shared) and contracts
// it with d warped/dx and d warped/dy, rebuilt in registers. Two barriers
// per block; 39.3 KB of shared memory at C=3. No conversion instruction
// turns the frame's bytes into floats (common.cuh, byte_to_float). C is a
// template argument (1-4 channels), so the channel loops unroll.
#include "common.cuh"

namespace {

using upe::kCols1;
using upe::kCols2;
using upe::kHalo1;
using upe::kHalo2;

template <int C>
constexpr size_t kSmemBytes = (2 * C * kHalo2 + 3 * C * kHalo1) * sizeof(float);

template <int C>
__global__ void __launch_bounds__(upe::kTallW * upe::kTallWarps, 4)
    warp_loss_bwd_kernel(const uint8_t* __restrict__ image,
                         const float* __restrict__ grid,
                         const float* __restrict__ target,
                         const float* __restrict__ g,
                         float* __restrict__ gx, float* __restrict__ gy,
                         int H, int W, float k_ssim, float k_l1, bool vec) {
  extern __shared__ float smem[];
  float* sp = smem;               // C planes of the warped frame, 2-px halo
  float* st = sp + C * kHalo2;    // C planes of the target, 2-px halo
  float* cf = st + C * kHalo2;    // C planes each of c_mu_p, c_sq, c_pt,
  const int nc = C * kHalo1;      // one-pixel halo
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * upe::kTallH;
  const int x0 = blockIdx.x * upe::kTallW;
  const long long plane = (long long)H * W;
  const float* gb = g + (long long)b * plane;
  const int lane = threadIdx.x, warp = threadIdx.y;

  upe::stage_warp_and_target<C, 2, upe::kRows2>(sp, st, image, grid, target,
                                                b, y0 - 2, x0, H, W, vec);
  __syncthreads();

  upe::coef_planes<C, 3>(
      sp, st, cf, [&](int y, int x) { return gb[(long long)y * W + x]; }, y0,
      x0, H, W, k_ssim);
  __syncthreads();

  // each thread: tile rows 2 warp and 2 warp + 1 of column lane
  const int ty = 2 * warp;
  const int i = y0 + ty, j = x0 + lane;
  if (i >= H || j >= W) return;
  const bool two = i + 1 < H;
  const upe::Taps ta = upe::warp_taps(image, grid, b, i, j, H, W, C);
  const upe::Taps tb =
      two ? upe::warp_taps(image, grid, b, i + 1, j, H, W, C) : ta;
  const float ga = gb[(long long)i * W + j];
  const float gbv = two ? gb[(long long)(i + 1) * W + j] : 0.0f;
  float ax[2] = {0.0f, 0.0f}, ay[2] = {0.0f, 0.0f};
  for (int c = 0; c < C; ++c) {
    const float* c_mu_p = cf + c * kHalo1;
    float mu[2], sq[2], pt[2];
    upe::adj3_pair<kCols1>(c_mu_p, lane, ty, i, j, H, W, &mu[0], &mu[1]);
    upe::adj3_pair<kCols1>(c_mu_p + nc, lane, ty, i, j, H, W, &sq[0],
                           &sq[1]);
    upe::adj3_pair<kCols1>(c_mu_p + 2 * nc, lane, ty, i, j, H, W, &pt[0],
                           &pt[1]);
    for (int r = 0; r < 2; ++r) {
      float p, ddx, ddy;
      upe::warp_channel(r == 0 ? ta : tb, c, &p, &ddx, &ddy);
      const float t = st[c * kHalo2 + (ty + r + 2) * kCols2 + lane + 2];
      const float d = p - t;
      const float sgn = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
      const float l1g = (k_l1 * (r == 0 ? ga : gbv)) * sgn;
      const float gp = ((l1g + mu[r]) + (2.0f * p) * sq[r]) + t * pt[r];
      ax[r] = ax[r] + gp * ddx;
      ay[r] = ay[r] + gp * ddy;
    }
  }
  const long long o = (long long)b * plane + (long long)i * W + j;
  gx[o] = ax[0];
  gy[o] = ay[0];
  if (two) {
    gx[o + W] = ax[1];
    gy[o + W] = ay[1];
  }
}

template <int C>
int launch(const uint8_t* image, const float* grid, const float* target,
           const float* g, float* gx, float* gy, int B, int H, int W,
           cudaStream_t stream) {
  const dim3 block(upe::kTallW, upe::kTallWarps);
  const dim3 blocks((W + upe::kTallW - 1) / upe::kTallW,
                    (H + upe::kTallH - 1) / upe::kTallH, B);
  const cudaError_t err =
      upe::allow_smem(warp_loss_bwd_kernel<C>, kSmemBytes<C>);
  if (err != cudaSuccess) return (int)err;
  const double inv_c = 1.0 / C;
  const bool vec = W % 4 == 0 && (uintptr_t)target % 16 == 0;
  warp_loss_bwd_kernel<C><<<blocks, block, kSmemBytes<C>, stream>>>(
      image, grid, target, g, gx, gy, H, W, (float)(0.85 * inv_c),
      (float)(0.15 * inv_c), vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int upe_warp_reproj_loss_bwd(const uint8_t* image,
                                        const float* grid,
                                        const float* target, const float* g,
                                        float* gx, float* gy, int B, int H,
                                        int W, int C, cudaStream_t stream) {
  switch (C) {
    case 1: return launch<1>(image, grid, target, g, gx, gy, B, H, W, stream);
    case 2: return launch<2>(image, grid, target, g, gx, gy, B, H, W, stream);
    case 3: return launch<3>(image, grid, target, g, gx, gy, B, H, W, stream);
    case 4: return launch<4>(image, grid, target, g, gx, gy, B, H, W, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
