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
// not. K6 (corners_kernel) takes one thread per output pixel; K7 and K8
// (corners_packed_kernel) one per run of 8 pixels of a row, described
// there. yl is clipped to [0, band - 2] as the JAX caller clips it, and
// the tap row and column are clamped into the image, so no read leaves the
// source whatever the indices.
//
// Bound on an H100 SXM: bytes; a gather does no arithmetic. At B=12, C=3,
// 192x640: K6 reads 17.7 MB of float32 planes and 11.8 MB of indices (one
// x0, yl pair per batch item, shared by its channels) and writes 70.8 MB,
// 30 us at 3.35 TB/s; K7 and K8 read the 4.4 MB uint8 frame and the same
// indices and write four bfloat16 planes (35.4 MB), 15 us. The 4.4 MB frame
// stays in the 50 MB L2, so staging bands in shared memory (TMA) would move
// more bytes from L2 than the taps need; K7 and K8 instead move their bytes
// in few, wide instructions with many in flight.
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

// ---------------------------------------------------------------------
// K7 and K8: image (B, H, W, C) uint8 -> four (B, C, H, W) bfloat16
// planes, which hold the integers 0..255 exactly.
//
// A thread owns a run of kPix consecutive output pixels of one row; a
// block of 256 threads covers kRows rows x 128 columns, so a K7 block row
// shares one band start (one per 16 rows) and a K8 block row one per row
// and 128-column chunk: the start's index is shifts and compile-time
// constants, the batch item is blockIdx.z, and no division is left. Per
// run: x0i and yl as 16-byte loads; each tap row's 2 C contiguous bytes
// from the aligned 8-byte chunks that hold them, shifted into place; each
// byte to bfloat16 by the exact float trick of common.cuh (2^23 + v, whose
// upper 16 bits after subtracting 2^23 are v's bfloat16), so no conversion
// instruction; and per corner and channel one 16-byte store of the run's
// 8 values. A ragged last run (W not a multiple of kPix), index rows that
// are not 16-byte aligned and output rows that are not (W not a multiple
// of 8) take a scalar path for their loads or stores.

constexpr int kPix = 8;                        // output pixels per thread
constexpr int kCols = 128;                     // columns per block
constexpr int kThreads = 256;                  // threads per block
constexpr int kRows = kThreads / (kCols / kPix);  // rows per block
static_assert(kPix == 8, "a run is one 16-byte store of 8 bfloat16s");

// The run's kPix indices at p (n of them in the image): 16-byte loads
// where the run is whole and p aligned, else one int per pixel.
__device__ __forceinline__ void load_run(const int* __restrict__ p, int n,
                                         int (&v)[kPix]) {
  if (n == kPix && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kPix / 4; ++q) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(p) + q);
      v[4 * q] = w.x;
      v[4 * q + 1] = w.y;
      v[4 * q + 2] = w.z;
      v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) v[k] = k < n ? __ldg(p + k) : 0;
  }
}

// Bytes p[0 .. 2C) (one tap row: C channels of the left tap, then of the
// right) as bytes 0-7 of (x, y), from the aligned 8-byte chunks that hold
// them. The second chunk is read only where the bytes cross into it, so
// every chunk read holds a byte of p[0 .. 2C): none lies past the frame.
template <int C>
__device__ __forceinline__ uint2 tap_row(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint2* q = reinterpret_cast<const uint2*>(a & ~uintptr_t{7});
  const int s = (int)(a & 7);
  const uint2 lo = __ldg(q);
  const uint2 hi = s + 2 * C > 8 ? __ldg(q + 1) : make_uint2(0u, 0u);
  const bool up = s >= 4;
  const uint32_t u0 = up ? lo.y : lo.x;
  const uint32_t u1 = up ? hi.x : lo.y;
  const uint32_t u2 = up ? hi.y : hi.x;
  const uint32_t sh = 8u * (uint32_t)(s & 3);
  return make_uint2(__funnelshift_r(u0, u1, sh), __funnelshift_r(u1, u2, sh));
}

// Byte k of a tap row as float bits: 0x4B0000vv is 2^23 + v, exact.
template <int K>
__device__ __forceinline__ float byte_of(uint2 t) {
  const uint32_t w = K < 4 ? t.x : t.y;
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | (K & 3))) -
         8388608.0f;
}

// Two bfloat16s (the upper halves of two exact floats) in one word, the
// first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// One corner plane's run: byte K of each pixel's tap row t[] -> the
// plane's kPix bfloat16 at out, in one 16-byte store where vec.
template <int K>
__device__ __forceinline__ void store_run(const uint2 (&t)[kPix],
                                          uint16_t* __restrict__ out,
                                          int n, bool vec) {
  uint32_t w[kPix / 2];
#pragma unroll
  for (int k = 0; k < kPix / 2; ++k) {
    w[k] = pack_bf16(byte_of<K>(t[2 * k]), byte_of<K>(t[2 * k + 1]));
  }
  if (vec) {
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (k < n) out[k] = (uint16_t)(w[k / 2] >> (16 * (k & 1)));
    }
  }
}

// Channels c.. of one side (D = 0 left tap, 1 right) of tap row t[], into
// planes out + c * plane.
template <int C, int D, int c = 0>
__device__ __forceinline__ void store_side(const uint2 (&t)[kPix],
                                           uint16_t* __restrict__ out,
                                           long long plane, int n,
                                           bool vec) {
  store_run<D * C + c>(t, out + c * plane, n, vec);
  if constexpr (c + 1 < C) store_side<C, D, c + 1>(t, out, plane, n, vec);
}

// PerRow: K8's band starts, (B, H, W / 128); else K7's, (B, H / 16, 1).
// No occupancy cap: 48 registers at C=3 (40 at C=1, 2; 60 at C=4), no
// spills, all 16 tap-row loads of a run in flight. On an H100 80GB HBM3 at
// 700 W, at B=12, C=3, 192x640, cold, each variant was slower: a cap of
// six blocks per SM (40 registers, spills), 4 pixels per thread, streaming
// stores, and the two tap rows one after the other.
template <int C, bool PerRow>
__global__ void __launch_bounds__(kThreads)
    corners_packed_kernel(const uint8_t* __restrict__ image,
                          const int* __restrict__ x0i,
                          const int* __restrict__ yl,
                          const int* __restrict__ ymin,
                          uint16_t* __restrict__ v00,
                          uint16_t* __restrict__ v01,
                          uint16_t* __restrict__ v10,
                          uint16_t* __restrict__ v11, int H, int W, int band,
                          bool out_vec) {
  constexpr int runs = kCols / kPix;  // threads per block row
  const int b = blockIdx.z;
  const int i = blockIdx.y * kRows + (int)threadIdx.x / runs;
  const int j0 = blockIdx.x * kCols + ((int)threadIdx.x % runs) * kPix;
  if (i >= H || j0 >= W) return;
  const int n = min(W - j0, kPix);
  const int start = __ldg(ymin + (PerRow ? (b * H + i) * (W >> 7) + blockIdx.x
                                         : b * (H >> 4) + (i >> 4)));
  const long long pix = ((long long)b * H + i) * W + j0;
  int x[kPix], y[kPix];
  load_run(x0i + pix, n, x);
  load_run(yl + pix, n, y);
  // the batch item's frame; offsets within it fit an int (the wrapper
  // refuses items of 2^31 bytes or more)
  const uint8_t* item = image + (long long)b * H * W * C;
  const int dy = W * C;
  uint2 top[kPix], bot[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int r = min(max(start + min(max(y[k], 0), band - 2), 0), H - 2);
    const int col = min(max(x[k], 0), W - 2);
    const uint8_t* p = item + (r * dy + col * C);
    top[k] = tap_row<C>(p);
    bot[k] = tap_row<C>(p + dy);
  }
  const long long plane = (long long)H * W;
  const long long o = ((long long)b * C * H + i) * W + j0;
  const bool vec = out_vec && n == kPix;
  store_side<C, 0>(top, v00 + o, plane, n, vec);
  store_side<C, 1>(top, v01 + o, plane, n, vec);
  store_side<C, 0>(bot, v10 + o, plane, n, vec);
  store_side<C, 1>(bot, v11 + o, plane, n, vec);
}

template <int C, bool PerRow>
int launch_packed(const uint8_t* image, const int* x0i, const int* yl,
                  const int* ymin, uint16_t* v00, uint16_t* v01,
                  uint16_t* v10, uint16_t* v11, int B, int H, int W,
                  int band, cudaStream_t stream) {
  const dim3 blocks((W + kCols - 1) / kCols, (H + kRows - 1) / kRows, B);
  const uintptr_t outs = reinterpret_cast<uintptr_t>(v00) |
                         reinterpret_cast<uintptr_t>(v01) |
                         reinterpret_cast<uintptr_t>(v10) |
                         reinterpret_cast<uintptr_t>(v11);
  // every run's output starts 16-byte aligned: W % 8 == 0, aligned planes
  const bool out_vec = W % 8 == 0 && (outs & 15) == 0;
  corners_packed_kernel<C, PerRow><<<blocks, kThreads, 0, stream>>>(
      image, x0i, yl, ymin, v00, v01, v10, v11, H, W, band, out_vec);
  return (int)cudaGetLastError();
}

template <bool PerRow>
int dispatch_packed(const uint8_t* image, const int* x0i, const int* yl,
                    const int* ymin, uint16_t* v00, uint16_t* v01,
                    uint16_t* v10, uint16_t* v11, int B, int C, int H,
                    int W, int band, cudaStream_t stream) {
  switch (C) {
    case 1: return launch_packed<1, PerRow>(image, x0i, yl, ymin, v00, v01,
                                            v10, v11, B, H, W, band, stream);
    case 2: return launch_packed<2, PerRow>(image, x0i, yl, ymin, v00, v01,
                                            v10, v11, B, H, W, band, stream);
    case 3: return launch_packed<3, PerRow>(image, x0i, yl, ymin, v00, v01,
                                            v10, v11, B, H, W, band, stream);
    case 4: return launch_packed<4, PerRow>(image, x0i, yl, ymin, v00, v01,
                                            v10, v11, B, H, W, band, stream);
    default: return (int)cudaErrorInvalidValue;
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

// rps, cps: output rows and columns per band start, 16 and W (K7) or 1
// and 128 (K8); any other layout, or C outside 1-4, is refused.
extern "C" int upe_fetch_corners_packed(const uint8_t* image, const int* x0i,
                                        const int* yl, const int* ymin,
                                        uint16_t* v00, uint16_t* v01,
                                        uint16_t* v10, uint16_t* v11, int B,
                                        int C, int H, int W, int rps,
                                        int cps, int band,
                                        cudaStream_t stream) {
  if (rps == 16 && cps == W && H % 16 == 0) {
    return dispatch_packed<false>(image, x0i, yl, ymin, v00, v01, v10, v11,
                                  B, C, H, W, band, stream);
  }
  if (rps == 1 && cps == kCols && W % kCols == 0) {
    return dispatch_packed<true>(image, x0i, yl, ymin, v00, v01, v10, v11, B,
                                 C, H, W, band, stream);
  }
  return (int)cudaErrorInvalidValue;
}
