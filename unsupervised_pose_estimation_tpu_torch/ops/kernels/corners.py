"""K6, K7, K8: the four bilinear corner taps of a warp, read from a band of
source rows.

CUDA kernels: ``csrc/corners.cu``. They replace the corner-fetch kernels of
``unsupervised_pose_estimation_tpu/ops/pallas/warp_kernel.py``:

- ``fetch_corners`` (K6): ``_fetch_corners`` with its rungs v1-v5 (float32
  planes in, float32 corners out);
- ``fetch_corners_packed`` (K7): ``_fetch_corners_packed`` (v6);
- ``fetch_corners_packed_v7`` (K8): ``_fetch_corners_packed_v7`` (v7).

K7 and K8 read the uint8 frame itself where the JAX kernels read its raw
0..255 float32 copy, and return the same bfloat16 planes. All three share
one device function and differ in the layout of the band starts ``ymin``.
On an H100 they are bound by bytes (a gather does no arithmetic): at B=12,
C=3, 192x640 K6 moves 100 MB (30 us at 3.35 TB/s), K7 and K8 52 MB (15 us).

Each output pixel's taps are ``src[row + {0, 1}, x0i + {0, 1}]`` with
``row = ymin + clip(yl, 0, band - 2)``, ``ymin`` being the start of the
pixel's band; ``row`` and ``x0i`` are clamped into the image, so reads stay
in the source whatever the indices. Where the ladder's gate for the rung
holds (every tap in its band), this equals the TPU kernel's output; where
it fails the ladder runs a lower rung, and the outputs differ (the TPU
kernels return zeros for taps outside the band).
"""

from __future__ import annotations

import torch

from . import _lib

LANE = 128  # output columns per band start of K8 (a TPU lane group)


def _check_indices(name, x0i, yl, ymin, b, h, w):
    """-> (rows, cols) of output pixels that share one band start."""
    for t, what in ((x0i, "x0i"), (yl, "yl"), (ymin, "ymin")):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
    for t, what in ((x0i, "x0i"), (yl, "yl")):
        if tuple(t.shape) != (b, h, w):
            raise ValueError(f"{name}: {what} must be {(b, h, w)}, got "
                             f"{tuple(t.shape)}")
    if (ymin.dim() != 3 or ymin.shape[0] != b or min(ymin.shape) < 1
            or h % ymin.shape[1] or w % ymin.shape[2]):
        raise ValueError(f"{name}: ymin {tuple(ymin.shape)} does not tile "
                         f"{(b, h, w)}")
    if h < 2 or w < 2:
        raise ValueError(f"{name}: planes must be at least 2x2")
    return h // ymin.shape[1], w // ymin.shape[2]


def _check_band(name, band, h):
    if not 2 <= band <= h:
        raise ValueError(f"{name}: band {band} outside [2, {h}]")


def expand_starts(ymin, h, w):
    """Band starts (B, H / rows, W / cols) -> each output pixel's (B, H, W)."""
    b, n_r, n_c = ymin.shape
    return ymin[:, :, None, :, None].expand(
        b, n_r, h // n_r, n_c, w // n_c).reshape(b, h, w)


def tap_index(x0i, yl, ymin, band, h, w):
    """Flat index ``row * w + col`` (B, H*W) of each pixel's top-left tap,
    with the kernels' clips and clamps."""
    row = torch.clamp(expand_starts(ymin, h, w) + torch.clamp(yl, 0, band - 2),
                      0, h - 2)
    col = torch.clamp(x0i, 0, w - 2)
    return (row * w + col).reshape(-1, h * w).long()


def gather_taps(flat, idx, w):
    """The four taps of ``flat`` (B, C, N) at ``idx`` (B, N) and its right,
    lower and lower-right neighbours -> 4 x (B, C, N)."""
    b, c, _ = flat.shape
    return tuple(torch.gather(flat, 2, (idx + off)[:, None].expand(b, c, -1))
                 for off in (0, 1, w, w + 1))


def fetch_corners_plain(src, x0i, yl, ymin, band):
    """Plain PyTorch version of K6.

    src (P, H, W) float32 planes, P = B * C, plane p = b * C + ch; x0i, yl
    (B, H, W) int32, shared by the channels of batch item b (the JAX kernel
    takes them repeated per plane); ymin (B, H // rows, 1) int32, one band
    start per ``rows`` output rows (8 for v1, v3, v4, v5; 1 for v2); band
    the band's height (40, 72 for the wide-band v3 rung, 16 for v2).
    -> v00, v01, v10, v11, each (P, H, W) float32.
    """
    p, h, w = _check_src(src, x0i)
    b = x0i.shape[0]
    _check_indices("fetch_corners", x0i, yl, ymin, b, h, w)
    _check_band("fetch_corners", band, h)
    idx = tap_index(x0i, yl, ymin, band, h, w)
    return tuple(t.reshape(p, h, w) for t in gather_taps(
        src.reshape(b, p // b, h * w), idx, w))


def _check_src(src, x0i):
    if src.dtype != torch.float32 or src.dim() != 3:
        raise TypeError(f"fetch_corners: src must be float32 (P, H, W), got "
                        f"{src.dtype} {tuple(src.shape)}")
    p, h, w = src.shape
    if x0i.dim() != 3 or x0i.shape[0] < 1 or p % x0i.shape[0]:
        raise ValueError(f"fetch_corners: {p} planes do not split over the "
                         f"batch of x0i {tuple(x0i.shape)}")
    return p, h, w


def fetch_corners(src, x0i, yl, ymin, band):
    """The corners of :func:`fetch_corners_plain`: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    p, h, w = _check_src(src, x0i)
    b = x0i.shape[0]
    rows, cols = _check_indices("fetch_corners", x0i, yl, ymin, b, h, w)
    _check_band("fetch_corners", band, h)
    if not _lib.on_cuda("fetch_corners", src, x0i, yl, ymin):
        return fetch_corners_plain(src, x0i, yl, ymin, band)
    out = [torch.empty_like(src) for _ in range(4)]
    with torch.cuda.device(src.device):
        _lib.launch("fetch_corners", "upe_fetch_corners", src.data_ptr(),
                    x0i.data_ptr(), yl.data_ptr(), ymin.data_ptr(),
                    *(t.data_ptr() for t in out), b, p // b, h, w, rows,
                    cols, band, _lib.stream_of(src))
    return tuple(out)


def _check_image(name, image):
    if image.dtype != torch.uint8 or image.dim() != 4:
        raise TypeError(f"{name}: image must be uint8 (B, H, W, C), got "
                        f"{image.dtype} {tuple(image.shape)}")
    return image.shape


def _packed_plain(name, image, x0i, yl, ymin, band):
    b, h, w, c = _check_image(name, image)
    _check_indices(name, x0i, yl, ymin, b, h, w)
    _check_band(name, band, h)
    idx = tap_index(x0i, yl, ymin, band, h, w)
    flat = image.reshape(b, h * w, c).permute(0, 2, 1)
    return tuple(t.to(torch.bfloat16).reshape(b, c * h, w)
                 for t in gather_taps(flat, idx, w))


def _packed(name, image, x0i, yl, ymin, band):
    b, h, w, c = _check_image(name, image)
    rows, cols = _check_indices(name, x0i, yl, ymin, b, h, w)
    _check_band(name, band, h)
    if not _lib.on_cuda(name, image, x0i, yl, ymin):
        return _packed_plain(name, image, x0i, yl, ymin, band)
    out = [torch.empty((b, c * h, w), dtype=torch.bfloat16,
                       device=image.device) for _ in range(4)]
    with torch.cuda.device(image.device):
        _lib.launch(name, "upe_fetch_corners_packed", image.data_ptr(),
                    x0i.data_ptr(), yl.data_ptr(), ymin.data_ptr(),
                    *(t.data_ptr() for t in out), b, c, h, w, rows, cols,
                    band, _lib.stream_of(image))
    return tuple(out)


MB7 = 16  # K8's miniband


def _check_v6_starts(ymin, h):
    if ymin.dim() != 3 or ymin.shape[1] * 16 != h or ymin.shape[2] != 1:
        raise ValueError(f"fetch_corners_packed: ymin must be (B, H/16, 1), "
                         f"got {tuple(ymin.shape)} for H={h}")


def _check_v7_starts(ymin, h, w):
    if ymin.dim() != 3 or ymin.shape[1] != h or ymin.shape[2] * LANE != w:
        raise ValueError(f"fetch_corners_packed_v7: ymin must be "
                         f"(B, H, W/128), got {tuple(ymin.shape)}")


def fetch_corners_packed_plain(image, x0i, yl, ymin, band):
    """Plain PyTorch version of K7.

    image (B, H, W, C) uint8; x0i, yl (B, H, W) int32 shared by the
    channels; ymin (B, H // 16, 1) int32, one start per 16 output rows;
    band the band's height (the ladder's is min(40, H)). -> v00, v01, v10,
    v11, each (B, C * H, W) bfloat16 holding the raw 0..255 values,
    channel ch in rows [ch * H, (ch + 1) * H).
    """
    _check_v6_starts(ymin, _check_image("fetch_corners_packed", image)[1])
    return _packed_plain("fetch_corners_packed", image, x0i, yl, ymin, band)


def fetch_corners_packed(image, x0i, yl, ymin, band):
    """The corners of :func:`fetch_corners_packed_plain`: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    _check_v6_starts(ymin, _check_image("fetch_corners_packed", image)[1])
    return _packed("fetch_corners_packed", image, x0i, yl, ymin, band)


def fetch_corners_packed_v7_plain(image, x0i, yl, ymin):
    """Plain PyTorch version of K8: as :func:`fetch_corners_packed_plain`,
    with ymin (B, H, W // 128) int32, one start per output row and
    128-column chunk, over a 16-row miniband."""
    _check_v7_starts(ymin, *_check_image("fetch_corners_packed_v7",
                                         image)[1:3])
    return _packed_plain("fetch_corners_packed_v7", image, x0i, yl, ymin,
                         MB7)


def fetch_corners_packed_v7(image, x0i, yl, ymin):
    """The corners of :func:`fetch_corners_packed_v7_plain`: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    _check_v7_starts(ymin, *_check_image("fetch_corners_packed_v7",
                                         image)[1:3])
    return _packed("fetch_corners_packed_v7", image, x0i, yl, ymin, MB7)
