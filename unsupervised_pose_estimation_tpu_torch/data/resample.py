"""Resizes in numpy that give PIL's bytes.

``resize_lanczos`` is ``Image.resize(..., Image.LANCZOS)`` of an 8-bit
image, bit for bit: Pillow's two-pass fixed-point resample
(``Resample.c``). Its coefficients are computed here in float64 and turned
into int32 with 22 fraction bits; the horizontal pass runs first, over the
rows the vertical pass reads; each sums ``2**21 + sum(pixel * k)`` in
integers and clips ``>> 22`` to 0..255; a pass whose size is unchanged is
skipped. The passes have a numpy route and a native one (the host routines
of ``csrc/image_host.cpp``, ``native=True``) with the same bytes.

``resize_nearest_pil`` is ``Image.resize(..., Image.NEAREST)`` of a 16-bit
grey image (KITTI's annotated depth). ``resize_nearest_np`` is a copy of
``unsupervised_pose_estimation_tpu/data/resample.py``'s rule for the
velodyne depth maps.
"""

from __future__ import annotations

import functools
import math

import numpy as np

PRECISION_BITS = 22   # 32 - 8 - 2, as Pillow's 8-bit passes
SUPPORT = 3.0         # LANCZOS's taps reach 3 input pixels at scale 1


def _lanczos(x: float) -> float:
    def sinc(v):
        if v == 0.0:
            return 1.0
        v *= math.pi
        return math.sin(v) / v

    if -SUPPORT <= x < SUPPORT:
        return sinc(x) * sinc(x / 3)
    return 0.0


@functools.lru_cache(maxsize=64)
def lanczos_coefficients(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` ->
    (bounds (out_size, 2) int32: first input index and tap count, kk
    (out_size, ksize) int32 weights with 22 fraction bits, 0 past the
    count), both read-only (they are cached)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    ss = 1.0 / filterscale
    support = SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int32)
    kk = np.zeros((out_size, ksize), np.int32)
    one = float(1 << PRECISION_BITS)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for v in w:  # in order, as C adds (sum() compensates)
            total += v
        for x, v in enumerate(w):
            if total != 0.0:
                v /= total
            kk[i, x] = int(v * one - 0.5) if v < 0 else int(v * one + 0.5)
        bounds[i] = xmin, xmax
    bounds.flags.writeable = False
    kk.flags.writeable = False
    return bounds, kk


def _clip8(ss: np.ndarray) -> np.ndarray:
    return np.clip(ss >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass_numpy(img: np.ndarray, axis: int, bounds, kk) -> np.ndarray:
    """One pass along ``axis`` (0: rows, 1: columns) of (H, W, C) uint8:
    one gather and multiply-add per tap, in int32 as Pillow sums."""
    n = img.shape[axis]
    ss = np.full(img.shape[:axis] + (len(bounds),) + img.shape[axis + 1:],
                 1 << (PRECISION_BITS - 1), np.int32)
    shape = [1] * img.ndim
    shape[axis] = len(bounds)
    for t in range(kk.shape[1]):
        idx = np.minimum(bounds[:, 0] + t, n - 1)
        k = np.where(t < bounds[:, 1], kk[:, t], 0).reshape(shape)
        ss += np.take(img, idx, axis=axis).astype(np.int32) * k
    return _clip8(ss)


def _horizontal_native(img, row0, rows, bounds, kk):
    from ..ops.kernels import _lib

    h, w, c = img.shape
    out = np.empty((rows, len(bounds), c), np.uint8)
    _lib.call_host("resample_horizontal_u8", "upe_resample_horizontal_u8",
                   img.ctypes.data, w, c, row0, rows, out.ctypes.data,
                   len(bounds), bounds.ctypes.data, kk.ctypes.data,
                   kk.shape[1])
    return out


def _vertical_native(img, bounds, kk):
    from ..ops.kernels import _lib

    h, w, c = img.shape
    out = np.empty((len(bounds), w, c), np.uint8)
    acc = np.empty(w * c, np.int32)
    _lib.call_host("resample_vertical_u8", "upe_resample_vertical_u8",
                   img.ctypes.data, w, c, out.ctypes.data, len(bounds),
                   bounds.ctypes.data, kk.ctypes.data, kk.shape[1],
                   acc.ctypes.data)
    return out


def resize_lanczos(img: np.ndarray, out_h: int, out_w: int,
                   native: bool = False) -> np.ndarray:
    """(H, W, C) or (H, W) uint8 -> (out_h, out_w[, C]) uint8, PIL's
    LANCZOS resize bit for bit; ``native`` takes the native passes."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_lanczos takes (H, W[, C]) uint8, got "
                         f"{img.shape} {img.dtype}")
    if out_h < 1 or out_w < 1:
        raise ValueError(f"resize_lanczos to {out_h}x{out_w}")
    h, w = img.shape[:2]
    if (out_h, out_w) == (h, w):
        return img.copy()
    grey = img.ndim == 2
    x = np.ascontiguousarray(img[..., None] if grey else img)
    bounds_v, kk_v = lanczos_coefficients(h, out_h)
    if out_w != w:
        bounds_h, kk_h = lanczos_coefficients(w, out_w)
        # only the rows the vertical pass reads
        first = int(bounds_v[0, 0])
        last = int(bounds_v[-1, 0] + bounds_v[-1, 1])
        if native:
            x = _horizontal_native(x, first, last - first, bounds_h, kk_h)
        else:
            x = _pass_numpy(x[first:last], 1, bounds_h, kk_h)
        bounds_v = bounds_v.copy()
        bounds_v[:, 0] -= first
    if out_h != h:
        x = (_vertical_native(x, bounds_v, kk_v) if native
             else _pass_numpy(x, 0, bounds_v, kk_v))
    return x[..., 0] if grey else x


def resize_nearest_pil(img: np.ndarray, out_h: int,
                       out_w: int) -> np.ndarray:
    """PIL's NEAREST resize of a 16-bit grey (``I;16``) image: output
    pixel i reads input ``int((in / out) * (i + 0.5))`` on each axis (its
    generic affine transform with the nearest filter)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.copy()
    rows = ((h / out_h) * (np.arange(out_h) + 0.5)).astype(np.int64)
    cols = ((w / out_w) * (np.arange(out_w) + 0.5)).astype(np.int64)
    return img[rows][:, cols]


def resize_nearest_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    rows = np.minimum((np.arange(out_h) * h / out_h).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(out_w) * w / out_w).astype(np.int64), w - 1)
    return img[rows][:, cols]
