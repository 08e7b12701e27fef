// K3: per-pixel SSIM + L1 photometric loss of two planar images.
//
// Replaces unsupervised_pose_estimation_tpu/ops/pallas/reproj_loss.py
// _kernel (launched by _forward). The TPU kernel holds a whole (H, W)
// plane per grid step in VMEM and accumulates the channel mean across
// sequential grid steps. Blocks on the GPU run in no order, so a block
// stages its tile and a one-pixel reflect halo of every channel of both
// images in shared memory, and each thread keeps its pixels' channel means
// in registers: every output is written once and nothing carries between
// blocks.
//
// Bound on an H100 SXM: bytes. It reads 2 * C floats and writes one float
// per pixel: at B=12, C=3, 192x640 that is 41.3 MB, 12.3 us at 3.35 TB/s
// (the ~80 float operations per pixel and channel need 5.3 us at 67
// TFLOP/s).
//
// Design against that bound (common.cuh, the tall tile), as K1 without the
// warp: a 32 x 16 tile per block of 256 threads, so the halo costs 1.20x
// the tile's positions; one pass over the halo, in which an interior tile
// with 16-byte aligned rows issues both planes' loads (interior rows as
// float4s) before it stores either; one barrier; then each thread scores
// two vertically adjacent pixels, whose windows share two rows. C is a
// template argument (1-4 channels), so the channel loops unroll.
#include "common.cuh"

namespace {

constexpr int kRows = upe::kTallH + 2;            // one-pixel halo rows
constexpr int kHalo = kRows * (upe::kTallW + 2);  // positions per plane

// Six blocks per SM (40 registers), as K1. On an H100 80GB HBM3 at 700 W
// the cap made no difference: four blocks (56 registers), eight (32, with
// spills) and no cap (48) ran within 0.001 ms of it at C=3.
template <int C>
__global__ void __launch_bounds__(upe::kTallW * upe::kTallWarps, 6)
    reproj_loss_kernel(const float* __restrict__ pred,
                       const float* __restrict__ target,
                       float* __restrict__ loss, int H, int W, bool vec) {
  __shared__ float sp[C * kHalo];  // C halo planes of pred
  __shared__ float st[C * kHalo];  // C halo planes of target
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * upe::kTallH;  // the tile's first image row
  const int x0 = blockIdx.x * upe::kTallW;  // and column
  if (vec && x0 + upe::kTallW <= W) {
    upe::PlanePrefetch<C, 1, kRows> p, t;
    p.load(pred, b, y0 - 1, x0, H, W);
    t.load(target, b, y0 - 1, x0, H, W);
    p.store(sp);
    t.store(st);
  } else {
    upe::stage_planes<C, 1, kRows>(sp, pred, b, y0 - 1, x0, H, W);
    upe::stage_planes<C, 1, kRows>(st, target, b, y0 - 1, x0, H, W);
  }
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
int launch(const float* pred, const float* target, float* loss, int B, int H,
           int W, cudaStream_t stream) {
  const dim3 block(upe::kTallW, upe::kTallWarps);
  const dim3 blocks((W + upe::kTallW - 1) / upe::kTallW,
                    (H + upe::kTallH - 1) / upe::kTallH, B);
  const bool vec = W % 4 == 0 && (uintptr_t)pred % 16 == 0 &&
                   (uintptr_t)target % 16 == 0;
  reproj_loss_kernel<C><<<blocks, block, 0, stream>>>(pred, target, loss, H,
                                                      W, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int upe_reproj_loss(const float* pred, const float* target,
                               float* loss, int B, int C, int H, int W,
                               cudaStream_t stream) {
  switch (C) {
    case 1: return launch<1>(pred, target, loss, B, H, W, stream);
    case 2: return launch<2>(pred, target, loss, B, H, W, stream);
    case 3: return launch<3>(pred, target, loss, B, H, W, stream);
    case 4: return launch<4>(pred, target, loss, B, H, W, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
