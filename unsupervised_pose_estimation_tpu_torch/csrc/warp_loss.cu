// K1: fused warp + SSIM/L1 photometric loss.
//
// Replaces unsupervised_pose_estimation_tpu/ops/pallas/warp_loss.py
// _warp_loss_kernel_v9 (launched by _warp_loss_fused_v9). The TPU kernel
// walks row blocks in order and carries the previous block's warped rows
// across grid steps to get the SSIM window's halo. Blocks on the GPU run in
// no order, so each block warps its own tile plus a one-pixel halo straight
// into shared memory and stages the target beside it; the warped frame
// never reaches device memory. The backward kernel (K2) rebuilds the warp
// from the frame and the grid, so K1 has no residual outputs.
//
// Bound on an H100 SXM: bytes. It reads C source bytes, 8 grid bytes and
// 4 * C target bytes and writes 4 loss bytes per pixel: at B=12, C=3,
// 192x640 that is 39.8 MB, 11.9 us at 3.35 TB/s (about 283 float
// operations per pixel, 6.2 us at 67 TFLOP/s).
//
// Design against that bound (common.cuh, the tall tile): a 32 x 16 tile
// per block of 256 threads, so the warped halo costs 1.20x the tile's
// positions; one pass over the halo in 2-D, with the target's interior rows
// read as float4s that are issued before the warp and stored after it, one
// barrier; then each thread scores two vertically adjacent pixels, whose
// windows share two rows (12 shared loads per channel and pixel instead of
// 18). C is a template argument (1-4 channels), so the channel loops
// unroll.
#include "common.cuh"

namespace {

constexpr int kRows = upe::kTallH + 2;            // one-pixel halo rows
constexpr int kHalo = kRows * (upe::kTallW + 2);  // positions per plane

// Six blocks per SM (40 registers): unbounded it takes 64 registers, only
// four blocks fit, and on an H100 it ran slower, its halo loads waiting on
// latency with fewer warps to cover them.
template <int C>
__global__ void __launch_bounds__(upe::kTallW * upe::kTallWarps, 6)
    warp_loss_kernel(const uint8_t* __restrict__ image,
                     const float* __restrict__ grid,
                     const float* __restrict__ target,
                     float* __restrict__ loss, int H, int W, bool vec) {
  __shared__ float sp[C * kHalo];  // C halo planes of the warped source
  __shared__ float st[C * kHalo];  // C halo planes of the target
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * upe::kTallH;  // the tile's first image row
  const int x0 = blockIdx.x * upe::kTallW;  // and column
  upe::stage_warp_and_target<C, 1, kRows>(sp, st, image, grid, target, b,
                                          y0 - 1, x0, H, W, vec);
  __syncthreads();
  const int ty = 2 * threadIdx.y;  // tile rows ty and ty + 1
  const int i = y0 + ty, j = x0 + threadIdx.x;
  if (i >= H || j >= W) return;
  float va, vb;
  upe::ssim_l1_score_pair<C, kRows>(sp, st, threadIdx.x, ty, &va, &vb);
  const long long o = ((long long)b * H + i) * W + j;
  loss[o] = va;
  if (i + 1 < H) loss[o + W] = vb;
}

template <int C>
int launch(const uint8_t* image, const float* grid, const float* target,
           float* loss, int B, int H, int W, cudaStream_t stream) {
  const dim3 block(upe::kTallW, upe::kTallWarps);
  const dim3 blocks((W + upe::kTallW - 1) / upe::kTallW,
                    (H + upe::kTallH - 1) / upe::kTallH, B);
  const bool vec = W % 4 == 0 && (uintptr_t)target % 16 == 0;
  warp_loss_kernel<C><<<blocks, block, 0, stream>>>(image, grid, target,
                                                    loss, H, W, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int upe_warp_reproj_loss(const uint8_t* image, const float* grid,
                                    const float* target, float* loss, int B,
                                    int H, int W, int C,
                                    cudaStream_t stream) {
  switch (C) {
    case 1: return launch<1>(image, grid, target, loss, B, H, W, stream);
    case 2: return launch<2>(image, grid, target, loss, B, H, W, stream);
    case 3: return launch<3>(image, grid, target, loss, B, H, W, stream);
    case 4: return launch<4>(image, grid, target, loss, B, H, W, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
