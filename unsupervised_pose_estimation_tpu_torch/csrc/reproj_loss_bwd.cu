// K4: backward of the SSIM + L1 photometric loss (K3) wrt the prediction,
// and wrt the target where one is asked for.
//
// Replaces unsupervised_pose_estimation_tpu/ops/pallas/reproj_loss.py
// _bwd_kernel (launched by _backward). The TPU kernel holds a whole (H, W)
// plane of one (batch, channel) per grid step and always writes both
// gradients. Here a block owns a 32 x 16 output tile and all C channels of
// it, and writes each gradient once. With WithTarget false (the training
// step's case: its targets are input frames) it forms no c_mu_t plane and
// writes no target gradient.
//
// Bound on an H100 SXM: bytes. Per pixel it reads 2 * C floats and the
// upstream gradient and writes C floats, or 2 * C with the target's
// gradient: at B=12, C=3, 192x640 that is 59.0 MB (17.6 us at 3.35 TB/s),
// or 76.7 MB (22.9 us) with it (about 175 float operations per pixel and
// channel, 11.6 us at 67 TFLOP/s).
//
// Design against that bound (common.cuh, the tall tile and its backward
// section), as K2 without the warp. One pass stages the prediction and
// the target of every channel on the two-pixel reflect halo (720 positions
// for 512 pixels) and the upstream gradient on the one-pixel halo, zero
// outside the image; on an interior tile with 16-byte aligned rows the two
// planes' loads (interior rows as float4s) are issued first, the gradient
// staged, and the planes stored after it. One pass forms the adjoint's
// coefficient planes of every channel on the one-pixel halo (612
// positions), three positions of a column per thread; then each thread
// applies the adjoint at two vertically adjacent pixels. Two barriers per
// block. Shared memory at C=3: 40.8 KB without the target, 48.0 KB with
// it. C is a template argument (1-4 channels), so the channel loops
// unroll.
#include "common.cuh"

namespace {

using upe::kCols1;
using upe::kCols2;
using upe::kHalo1;
using upe::kHalo2;
using upe::kRows1;
using upe::kRows2;

// p and t on the two-pixel halo, g and NP coefficient planes per channel
// on the one-pixel halo
template <int C, int NP>
constexpr size_t kSmemBytes =
    (2 * C * kHalo2 + kHalo1 + NP * C * kHalo1) * sizeof(float);

// Four blocks per SM (up to 64 registers) in both instances, as K2. On an
// H100 80GB HBM3 at 700 W, C=3, that ran fastest: three blocks (up to 72
// registers) took 0.005 ms more with the target's gradient and 0.001 ms
// more without; without it, five blocks (48 registers, which its 40.8 KB
// of shared memory allows) took 0.002 ms more; with no cap (48 registers)
// it ran as four with the target's gradient and 0.0015 ms slower without.
template <int C, bool WithTarget>
__global__ void __launch_bounds__(upe::kTallW * upe::kTallWarps, 4)
    reproj_loss_bwd_kernel(const float* __restrict__ pred,
                           const float* __restrict__ target,
                           const float* __restrict__ g,
                           float* __restrict__ gpred,
                           float* __restrict__ gtarget, int H, int W,
                           float k_ssim, float k_l1, bool vec) {
  constexpr int NP = WithTarget ? 4 : 3;
  extern __shared__ float smem[];
  float* sp = smem;             // C planes of pred, two-pixel halo
  float* st = sp + C * kHalo2;  // C planes of target, two-pixel halo
  float* sg = st + C * kHalo2;  // g, one-pixel halo
  float* cf = sg + kHalo1;      // C planes each of c_mu_p, c_sq, c_pt
  const int nc = C * kHalo1;    // (and c_mu_t), one-pixel halo
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * upe::kTallH;
  const int x0 = blockIdx.x * upe::kTallW;
  const float* gb = g + (long long)b * H * W;
  const int lane = threadIdx.x, warp = threadIdx.y;

  auto stage_g = [&] {
    upe::for_each_halo<1, kRows1>([&](int hy, int hx) {
      const int y = y0 - 1 + hy, x = x0 - 1 + hx;
      sg[hy * kCols1 + hx] = y >= 0 && y < H && x >= 0 && x < W
                                 ? gb[(long long)y * W + x]
                                 : 0.0f;
    });
  };
  if (vec && x0 + upe::kTallW <= W) {
    upe::PlanePrefetch<C, 2, kRows2> p, t;
    p.load(pred, b, y0 - 2, x0, H, W);
    t.load(target, b, y0 - 2, x0, H, W);
    stage_g();
    p.store(sp);
    t.store(st);
  } else {
    upe::stage_planes<C, 2, kRows2>(sp, pred, b, y0 - 2, x0, H, W);
    upe::stage_planes<C, 2, kRows2>(st, target, b, y0 - 2, x0, H, W);
    stage_g();
  }
  __syncthreads();

  upe::coef_planes<C, NP>(
      sp, st, cf,
      [&](int y, int x) { return sg[(y - y0 + 1) * kCols1 + x - x0 + 1]; },
      y0, x0, H, W, k_ssim);
  __syncthreads();

  // each thread: tile rows 2 warp and 2 warp + 1 of column lane
  const int ty = 2 * warp;
  const int i = y0 + ty, j = x0 + lane;
  if (i >= H || j >= W) return;
  const bool two = i + 1 < H;
  for (int c = 0; c < C; ++c) {
    const float* c_mu_p = cf + c * kHalo1;
    float mu[2], sq[2], pt[2], mt[2];
    upe::adj3_pair<kCols1>(c_mu_p, lane, ty, i, j, H, W, &mu[0], &mu[1]);
    upe::adj3_pair<kCols1>(c_mu_p + nc, lane, ty, i, j, H, W, &sq[0],
                           &sq[1]);
    upe::adj3_pair<kCols1>(c_mu_p + 2 * nc, lane, ty, i, j, H, W, &pt[0],
                           &pt[1]);
    if (WithTarget) {
      upe::adj3_pair<kCols1>(c_mu_p + 3 * nc, lane, ty, i, j, H, W, &mt[0],
                             &mt[1]);
    }
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !two) break;
      const int k = c * kHalo2 + (ty + r + 2) * kCols2 + lane + 2;
      const float p = sp[k], t = st[k];
      const float d = p - t;
      const float sgn = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
      const float l1g = (k_l1 * sg[(ty + r + 1) * kCols1 + lane + 1]) * sgn;
      const long long o = (((long long)b * C + c) * H + i + r) * W + j;
      gpred[o] = ((l1g + mu[r]) + (2.0f * p) * sq[r]) + t * pt[r];
      if (WithTarget) {
        gtarget[o] = ((-l1g + mt[r]) + (2.0f * t) * sq[r]) + p * pt[r];
      }
    }
  }
}

template <int C, bool WithTarget>
int launch(const float* pred, const float* target, const float* g,
           float* gpred, float* gtarget, int B, int H, int W,
           cudaStream_t stream) {
  constexpr size_t smem = kSmemBytes<C, WithTarget ? 4 : 3>;
  const dim3 block(upe::kTallW, upe::kTallWarps);
  const dim3 blocks((W + upe::kTallW - 1) / upe::kTallW,
                    (H + upe::kTallH - 1) / upe::kTallH, B);
  const cudaError_t err =
      upe::allow_smem(reproj_loss_bwd_kernel<C, WithTarget>, smem);
  if (err != cudaSuccess) return (int)err;
  const double inv_c = 1.0 / C;
  const bool vec = W % 4 == 0 && (uintptr_t)pred % 16 == 0 &&
                   (uintptr_t)target % 16 == 0;
  reproj_loss_bwd_kernel<C, WithTarget><<<blocks, block, smem, stream>>>(
      pred, target, g, gpred, gtarget, H, W, (float)(0.85 * inv_c),
      (float)(0.15 * inv_c), vec);
  return (int)cudaGetLastError();
}

template <int C>
int launch_c(const float* pred, const float* target, const float* g,
             float* gpred, float* gtarget, int B, int H, int W,
             cudaStream_t stream) {
  if (gtarget == nullptr) {
    return launch<C, false>(pred, target, g, gpred, gtarget, B, H, W, stream);
  }
  return launch<C, true>(pred, target, g, gpred, gtarget, B, H, W, stream);
}

}  // namespace

// gtarget null: the instance that writes dL/dpred alone.
extern "C" int upe_reproj_loss_bwd(const float* pred, const float* target,
                                   const float* g, float* gpred,
                                   float* gtarget, int B, int C, int H, int W,
                                   cudaStream_t stream) {
  switch (C) {
    case 1: return launch_c<1>(pred, target, g, gpred, gtarget, B, H, W, stream);
    case 2: return launch_c<2>(pred, target, g, gpred, gtarget, B, H, W, stream);
    case 3: return launch_c<3>(pred, target, g, gpred, gtarget, B, H, W, stream);
    case 4: return launch_c<4>(pred, target, g, gpred, gtarget, B, H, W, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
