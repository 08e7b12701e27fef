// K4: backward of the SSIM + L1 photometric loss (K3) wrt both images.
//
// Replaces unsupervised_pose_estimation_tpu/ops/pallas/reproj_loss.py
// _bwd_kernel (launched by _backward). The TPU kernel holds a whole (H, W)
// plane of one (batch, channel) per grid step. Here a block owns a 32 x 8
// output tile and loops over the channels (common.cuh,
// ssim_l1_grad_channel): per channel it stages prediction and target with a
// two-pixel reflect halo, forms the SSIM adjoint's coefficient planes on a
// one-pixel halo and applies the adjoint of the reflect-padded window at
// each pixel, writing that channel's g_pred and g_target once.
//
// Bound on an H100 SXM: bytes. Per pixel it reads 2 * C floats and the
// upstream gradient and writes 2 * C floats: at B=12, C=3, 192x640 that is
// 76.7 MB, 22.9 us at 3.35 TB/s (about 175 float operations per pixel and
// channel, 11.6 us at 67 TFLOP/s).
#include "common.cuh"

namespace {

__global__ void reproj_loss_bwd_kernel(const float* __restrict__ pred,
                                       const float* __restrict__ target,
                                       const float* __restrict__ g,
                                       float* __restrict__ gpred,
                                       float* __restrict__ gtarget, int C,
                                       int H, int W, float k_ssim,
                                       float k_l1) {
  __shared__ upe::BwdSmem sm;
  const int b = blockIdx.z;
  const int oy = blockIdx.y * upe::kTileH - 1;
  const int ox = blockIdx.x * upe::kTileW - 1;
  const int i = oy + 1 + threadIdx.y;
  const int j = ox + 1 + threadIdx.x;
  const long long plane = (long long)H * W;
  upe::stage_grad(sm, g, b, oy, ox, H, W);
  for (int c = 0; c < C; ++c) {
    const long long base = ((long long)b * C + c) * plane;
    float gt = 0.0f;
    const float gp = upe::ssim_l1_grad_channel(sm, pred, target, base, oy,
                                               ox, i, j, H, W, k_ssim, k_l1,
                                               &gt);
    if (i < H && j < W) {
      const long long o = base + (long long)i * W + j;
      gpred[o] = gp;
      gtarget[o] = gt;
    }
  }
}

}  // namespace

extern "C" int upe_reproj_loss_bwd(const float* pred, const float* target,
                                   const float* g, float* gpred,
                                   float* gtarget, int B, int C, int H, int W,
                                   cudaStream_t stream) {
  const dim3 block(upe::kTileW, upe::kTileH);
  const dim3 blocks((W + upe::kTileW - 1) / upe::kTileW,
                    (H + upe::kTileH - 1) / upe::kTileH, B);
  const double inv_c = 1.0 / C;
  reproj_loss_bwd_kernel<<<blocks, block, 0, stream>>>(
      pred, target, g, gpred, gtarget, C, H, W, (float)(0.85 * inv_c),
      (float)(0.15 * inv_c));
  return (int)cudaGetLastError();
}
