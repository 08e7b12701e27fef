// K5: bilinear warp of a uint8 frame with the two coordinate-gradient planes.
//
// Replaces unsupervised_pose_estimation_tpu/ops/pallas/warp_kernel.py
// _warp_lerp_kernel_v8 (launched by _warp_lerp_fused_v8) and, because it
// gathers straight from device memory at any displacement, also the
// large-motion rungs behind it (_corner_kernel_v4 / _v3 and the XLA gather
// of _sample_impl). The TPU kernel fetches taps from 16-row source bands
// held in VMEM because TPU gathers are slow; here one thread per output
// pixel reads its four taps (3 contiguous bytes each) through the L1/L2
// caches, which hold the few source rows a block of neighbouring pixels
// touches.
//
// Bound on an H100 SXM: bytes. Per pixel it reads C bytes of source (once,
// counted) and 8 bytes of grid, and writes 3 * C floats: at B=12, C=3,
// 192x640 that is 69.3 MB, 20.7 us at 3.35 TB/s.
#include "common.cuh"

namespace {

__global__ void warp_kernel(const uint8_t* __restrict__ image,
                            const float* __restrict__ grid,
                            float* __restrict__ warped,
                            float* __restrict__ ddx, float* __restrict__ ddy,
                            int H, int W, int C) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= H || j >= W) return;
  const upe::Taps t = upe::warp_taps(image, grid, b, i, j, H, W, C);
  const long long plane = (long long)H * W;
  long long o = (long long)b * C * plane + (long long)i * W + j;
  for (int c = 0; c < C; ++c, o += plane) {
    upe::warp_channel(t, c, warped + o, ddx + o, ddy + o);
  }
}

}  // namespace

extern "C" int upe_warp(const uint8_t* image, const float* grid,
                        float* warped, float* ddx, float* ddy, int B, int H,
                        int W, int C, cudaStream_t stream) {
  const dim3 block(upe::kTileW, upe::kTileH);
  const dim3 blocks((W + block.x - 1) / block.x, (H + block.y - 1) / block.y,
                    B);
  warp_kernel<<<blocks, block, 0, stream>>>(image, grid, warped, ddx, ddy, H,
                                            W, C);
  return (int)cudaGetLastError();
}

extern "C" const char* upe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
