// K3: per-pixel SSIM + L1 photometric loss of two planar images.
//
// Replaces unsupervised_pose_estimation_tpu/ops/pallas/reproj_loss.py
// _kernel (launched by _forward). The TPU kernel holds a whole (H, W)
// plane per grid step in VMEM and accumulates the channel mean across
// sequential grid steps. Here a block owns a 32 x 8 output tile: it stages
// the tile and a one-pixel reflect halo of every channel of both images in
// shared memory, and each thread keeps its pixel's channel mean in a
// register, so every output is written once and nothing carries between
// blocks.
//
// Bound on an H100 SXM: bytes. It reads 2 * C floats and writes one float
// per pixel: at B=12, C=3, 192x640 that is 41.3 MB, 12.3 us at 3.35 TB/s
// (the ~80 float operations per pixel and channel need 5.3 us at 67 TFLOP/s).
#include "common.cuh"

namespace {

__global__ void reproj_loss_kernel(const float* __restrict__ pred,
                                   const float* __restrict__ target,
                                   float* __restrict__ loss, int C, int H,
                                   int W) {
  extern __shared__ float smem[];
  float* sp = smem;                 // C halo planes of pred
  float* st = smem + C * upe::kHalo;  // C halo planes of target
  const int b = blockIdx.z;
  const int oy = blockIdx.y * upe::kTileH - 1;
  const int ox = blockIdx.x * upe::kTileW - 1;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const long long plane = (long long)H * W;
  for (int k = tid; k < upe::kHalo; k += blockDim.x * blockDim.y) {
    const int gy = upe::reflect_clamp(oy + k / upe::kHaloW, H);
    const int gx = upe::reflect_clamp(ox + k % upe::kHaloW, W);
    long long o = (long long)b * C * plane + (long long)gy * W + gx;
    for (int c = 0; c < C; ++c, o += plane) {
      sp[c * upe::kHalo + k] = pred[o];
      st[c * upe::kHalo + k] = target[o];
    }
  }
  __syncthreads();
  const int i = oy + 1 + threadIdx.y;
  const int j = ox + 1 + threadIdx.x;
  if (i >= H || j >= W) return;
  loss[(long long)b * plane + (long long)i * W + j] =
      upe::ssim_l1_score(sp, st, C, threadIdx.x, threadIdx.y);
}

}  // namespace

extern "C" int upe_reproj_loss(const float* pred, const float* target,
                               float* loss, int B, int C, int H, int W,
                               cudaStream_t stream) {
  const dim3 block(upe::kTileW, upe::kTileH);
  const dim3 blocks((W + upe::kTileW - 1) / upe::kTileW,
                    (H + upe::kTileH - 1) / upe::kTileH, B);
  const size_t smem = 2 * (size_t)C * upe::kHalo * sizeof(float);
  reproj_loss_kernel<<<blocks, block, smem, stream>>>(pred, target, loss, C,
                                                      H, W);
  return (int)cudaGetLastError();
}
