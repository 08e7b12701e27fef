// K1: fused warp + SSIM/L1 photometric loss.
//
// Replaces unsupervised_pose_estimation_tpu/ops/pallas/warp_loss.py
// _warp_loss_kernel_v9 (launched by _warp_loss_fused_v9). The TPU kernel
// walks row blocks in order and carries the previous block's warped rows
// across grid steps to get the SSIM window's halo. Blocks on the GPU run in
// no order, so each block instead warps its 32 x 8 tile plus a one-pixel
// halo straight into shared memory (the halo's 108 pixels are warped twice
// across neighbouring blocks), stages the target the same way, and scores
// the tile. The warped frame never reaches device memory unless the caller
// asks for the residuals (warped, d/dwx, d/dwy) that the backward kernel
// of the training step needs.
//
// Bound on an H100 SXM: bytes. Without residuals it reads C source bytes,
// 8 grid bytes and 4 * C target bytes and writes 4 loss bytes per pixel:
// at B=12, C=3, 192x640 that is 39.8 MB, 11.9 us at 3.35 TB/s.
#include "common.cuh"

namespace {

__global__ void warp_loss_kernel(const uint8_t* __restrict__ image,
                                 const float* __restrict__ grid,
                                 const float* __restrict__ target,
                                 float* __restrict__ loss,
                                 float* __restrict__ warped,
                                 float* __restrict__ ddx,
                                 float* __restrict__ ddy, int H, int W,
                                 int C) {
  extern __shared__ float smem[];
  float* sp = smem;                   // C halo planes of the warped source
  float* st = smem + C * upe::kHalo;  // C halo planes of the target
  const int b = blockIdx.z;
  const int oy = blockIdx.y * upe::kTileH - 1;
  const int ox = blockIdx.x * upe::kTileW - 1;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const long long plane = (long long)H * W;
  for (int k = tid; k < upe::kHalo; k += blockDim.x * blockDim.y) {
    const int gy = upe::reflect_clamp(oy + k / upe::kHaloW, H);
    const int gx = upe::reflect_clamp(ox + k % upe::kHaloW, W);
    const upe::Taps t = upe::warp_taps(image, grid, b, gy, gx, H, W, C);
    long long o = (long long)b * C * plane + (long long)gy * W + gx;
    for (int c = 0; c < C; ++c, o += plane) {
      upe::warp_channel(t, c, sp + c * upe::kHalo + k, nullptr, nullptr);
      st[c * upe::kHalo + k] = target[o];
    }
  }
  __syncthreads();
  const int i = oy + 1 + threadIdx.y;
  const int j = ox + 1 + threadIdx.x;
  if (i >= H || j >= W) return;
  loss[(long long)b * plane + (long long)i * W + j] =
      upe::ssim_l1_score(sp, st, C, threadIdx.x, threadIdx.y);
  if (warped != nullptr) {
    const upe::Taps t = upe::warp_taps(image, grid, b, i, j, H, W, C);
    long long o = (long long)b * C * plane + (long long)i * W + j;
    for (int c = 0; c < C; ++c, o += plane) {
      upe::warp_channel(t, c, warped + o, ddx + o, ddy + o);
    }
  }
}

}  // namespace

extern "C" int upe_warp_reproj_loss(const uint8_t* image, const float* grid,
                                    const float* target, float* loss,
                                    float* warped, float* ddx, float* ddy,
                                    int B, int H, int W, int C,
                                    cudaStream_t stream) {
  const dim3 block(upe::kTileW, upe::kTileH);
  const dim3 blocks((W + upe::kTileW - 1) / upe::kTileW,
                    (H + upe::kTileH - 1) / upe::kTileH, B);
  const size_t smem = 2 * (size_t)C * upe::kHalo * sizeof(float);
  warp_loss_kernel<<<blocks, block, smem, stream>>>(image, grid, target, loss,
                                                    warped, ddx, ddy, H, W, C);
  return (int)cudaGetLastError();
}
