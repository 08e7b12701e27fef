// K2: backward of the fused warp + SSIM/L1 loss (K1) wrt the warp's
// pixel coordinates.
//
// Replaces unsupervised_pose_estimation_tpu/ops/pallas/warp_loss.py
// _bwd_kernel (launched by _warp_loss_bwd_call). The TPU kernel holds one
// (batch, channel) plane per grid step and accumulates the two coordinate
// cotangents across the sequential channel axis of its grid. GPU blocks run
// in no order, so here a block owns a 32 x 8 output tile and loops over the
// C channels itself (common.cuh, ssim_l1_grad_channel): per channel it
// stages the warped image and the target with a two-pixel reflect halo,
// forms the SSIM adjoint's coefficient planes on a one-pixel halo and
// applies the adjoint of the reflect-padded window at each pixel. Each
// thread contracts dL/dwarped with the saved d warped/dx and d warped/dy
// planes (K1's residuals) in registers, so gx and gy are written once, with
// no atomics. The target's cotangent is not formed: targets are input
// frames.
//
// Bound on an H100 SXM: bytes. Per pixel it reads 4 * C floats (warped,
// target, ddx, ddy) and the upstream gradient and writes two floats: at
// B=12, C=3, 192x640 that is 88.5 MB, 26.4 us at 3.35 TB/s (about 156 float
// operations per pixel and channel, 10.3 us at 67 TFLOP/s).
#include "common.cuh"

namespace {

__global__ void warp_loss_bwd_kernel(const float* __restrict__ warped,
                                     const float* __restrict__ target,
                                     const float* __restrict__ ddx,
                                     const float* __restrict__ ddy,
                                     const float* __restrict__ g,
                                     float* __restrict__ gx,
                                     float* __restrict__ gy, int C, int H,
                                     int W, float k_ssim, float k_l1) {
  __shared__ upe::BwdSmem sm;
  const int b = blockIdx.z;
  const int oy = blockIdx.y * upe::kTileH - 1;
  const int ox = blockIdx.x * upe::kTileW - 1;
  const int i = oy + 1 + threadIdx.y;
  const int j = ox + 1 + threadIdx.x;
  const long long plane = (long long)H * W;
  upe::stage_grad(sm, g, b, oy, ox, H, W);
  float ax = 0.0f, ay = 0.0f;
  for (int c = 0; c < C; ++c) {
    const long long base = ((long long)b * C + c) * plane;
    const float gp = upe::ssim_l1_grad_channel(sm, warped, target, base, oy,
                                               ox, i, j, H, W, k_ssim, k_l1,
                                               nullptr);
    if (i < H && j < W) {
      const long long o = base + (long long)i * W + j;
      ax = ax + gp * ddx[o];
      ay = ay + gp * ddy[o];
    }
  }
  if (i < H && j < W) {
    const long long o = (long long)b * plane + (long long)i * W + j;
    gx[o] = ax;
    gy[o] = ay;
  }
}

}  // namespace

extern "C" int upe_warp_reproj_loss_bwd(const float* warped,
                                        const float* target, const float* ddx,
                                        const float* ddy, const float* g,
                                        float* gx, float* gy, int B, int C,
                                        int H, int W, cudaStream_t stream) {
  const dim3 block(upe::kTileW, upe::kTileH);
  const dim3 blocks((W + upe::kTileW - 1) / upe::kTileW,
                    (H + upe::kTileH - 1) / upe::kTileH, B);
  const double inv_c = 1.0 / C;
  warp_loss_bwd_kernel<<<blocks, block, 0, stream>>>(
      warped, target, ddx, ddy, g, gx, gy, C, H, W, (float)(0.85 * inv_c),
      (float)(0.15 * inv_c));
  return (int)cudaGetLastError();
}
