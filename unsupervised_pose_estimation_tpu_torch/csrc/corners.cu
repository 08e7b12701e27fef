// K6, K7, K8: the four bilinear corner taps of a warp, read from a band of
// source rows.
//
// Replaces, in unsupervised_pose_estimation_tpu/ops/pallas/warp_kernel.py:
//   K6 _fetch_corners -> _corner_kernel (v1), _corner_kernel_v2 .. _v5;
//   K7 _fetch_corners_packed -> _corner_kernel_v6;
//   K8 _fetch_corners_packed_v7 -> _corner_kernel_v7.
// Each output pixel (b, i, j) has a left tap column x0 and a top tap row
// yl local to a band of `band` source rows, which starts at row ymin; one
// start is shared by `rps` output rows and `cps` output columns (v1, v3,
// v4, v5: 8 rows and the whole width; v2: each row; v6: 16 rows; v7: each
// row and 128-column chunk). The taps are src[ymin + yl + {0, 1},
// x0 + {0, 1}] of every channel. The TPU rungs are five ways of getting
// Mosaic to reach those taps without a gather (lane gathers, group guards,
// masked row sums over a band held in VMEM); when the caller's band gate
// holds they equal that gather, and the ladder discards them when it does
// not. Here one thread per output pixel reads its x0 and yl (neighbouring
// threads on neighbouring words) and the ymin of its row block, then the
// taps of all channels through the read-only cache, and writes each corner
// plane once. yl is clipped to [0, band - 2] as the JAX caller clips it,
// and the tap row and column are clamped into the image, so no read leaves
// the source whatever the indices.
//
// Bound on an H100 SXM: bytes; a gather does no arithmetic. At B=12, C=3,
// 192x640: K6 reads 17.7 MB of float32 planes and 11.8 MB of indices (one
// x0, yl pair per batch item, shared by its channels) and writes 70.8 MB,
// 30 us at 3.35 TB/s; K7 and K8 read the 4.4 MB uint8 frame and the same
// indices and write four bfloat16 planes (35.4 MB), 15 us.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

struct Tap {
  long long pixel;  // (b * H + i) * W + j
  int row, col;     // source row and column of the top-left tap
};

__device__ __forceinline__ bool tap_of(const int* __restrict__ x0i,
                                       const int* __restrict__ yl,
                                       const int* __restrict__ ymin, int H,
                                       int W, int rps, int cps, int band,
                                       Tap* t) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= H || j >= W) return false;
  t->pixel = ((long long)b * H + i) * W + j;
  const int n_r = H / rps, n_c = W / cps;
  const int start =
      __ldg(ymin + ((long long)b * n_r + i / rps) * n_c + j / cps);
  const int y = min(max(__ldg(yl + t->pixel), 0), band - 2);
  t->row = min(max(start + y, 0), H - 2);
  t->col = min(max(__ldg(x0i + t->pixel), 0), W - 2);
  return true;
}

// src (B, C, H, W) float32 planes -> four (B, C, H, W) float32 planes.
__global__ void corners_kernel(const float* __restrict__ src,
                               const int* __restrict__ x0i,
                               const int* __restrict__ yl,
                               const int* __restrict__ ymin,
                               float* __restrict__ v00,
                               float* __restrict__ v01,
                               float* __restrict__ v10,
                               float* __restrict__ v11, int C, int H, int W,
                               int rps, int cps, int band) {
  Tap t;
  if (!tap_of(x0i, yl, ymin, H, W, rps, cps, band, &t)) return;
  const long long plane = (long long)H * W;
  const long long b = t.pixel / plane;
  long long o = t.pixel + b * (C - 1) * plane;  // channel 0 of the output
  const float* s = src + b * C * plane + (long long)t.row * W + t.col;
  for (int c = 0; c < C; ++c, o += plane, s += plane) {
    v00[o] = __ldg(s);
    v01[o] = __ldg(s + 1);
    v10[o] = __ldg(s + W);
    v11[o] = __ldg(s + W + 1);
  }
}

// image (B, H, W, C) uint8 -> four (B, C, H, W) bfloat16 planes, which hold
// the integers 0..255 exactly.
__global__ void corners_packed_kernel(const uint8_t* __restrict__ image,
                                      const int* __restrict__ x0i,
                                      const int* __restrict__ yl,
                                      const int* __restrict__ ymin,
                                      __nv_bfloat16* __restrict__ v00,
                                      __nv_bfloat16* __restrict__ v01,
                                      __nv_bfloat16* __restrict__ v10,
                                      __nv_bfloat16* __restrict__ v11, int C,
                                      int H, int W, int rps, int cps,
                                      int band) {
  Tap t;
  if (!tap_of(x0i, yl, ymin, H, W, rps, cps, band, &t)) return;
  const long long plane = (long long)H * W;
  const long long b = t.pixel / plane;
  long long o = t.pixel + b * (C - 1) * plane;
  const uint8_t* p = image + ((b * H + t.row) * W + t.col) * C;
  const int dy = W * C;
  for (int c = 0; c < C; ++c, o += plane) {
    v00[o] = __float2bfloat16_rn((float)__ldg(p + c));
    v01[o] = __float2bfloat16_rn((float)__ldg(p + C + c));
    v10[o] = __float2bfloat16_rn((float)__ldg(p + dy + c));
    v11[o] = __float2bfloat16_rn((float)__ldg(p + dy + C + c));
  }
}

dim3 grid_of(int B, int H, int W) {
  return dim3((W + upe::kTileW - 1) / upe::kTileW,
              (H + upe::kTileH - 1) / upe::kTileH, B);
}

}  // namespace

extern "C" int upe_fetch_corners(const float* src, const int* x0i,
                                 const int* yl, const int* ymin, float* v00,
                                 float* v01, float* v10, float* v11, int B,
                                 int C, int H, int W, int rps, int cps,
                                 int band, cudaStream_t stream) {
  corners_kernel<<<grid_of(B, H, W), dim3(upe::kTileW, upe::kTileH), 0,
                   stream>>>(src, x0i, yl, ymin, v00, v01, v10, v11, C, H, W,
                             rps, cps, band);
  return (int)cudaGetLastError();
}

extern "C" int upe_fetch_corners_packed(const uint8_t* image, const int* x0i,
                                        const int* yl, const int* ymin,
                                        __nv_bfloat16* v00,
                                        __nv_bfloat16* v01,
                                        __nv_bfloat16* v10,
                                        __nv_bfloat16* v11, int B, int C,
                                        int H, int W, int rps, int cps,
                                        int band, cudaStream_t stream) {
  corners_packed_kernel<<<grid_of(B, H, W), dim3(upe::kTileW, upe::kTileH), 0,
                          stream>>>(image, x0i, yl, ymin, v00, v01, v10, v11,
                                    C, H, W, rps, cps, band);
  return (int)cudaGetLastError();
}
