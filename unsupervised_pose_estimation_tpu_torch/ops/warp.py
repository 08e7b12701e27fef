"""Bilinear sampling with ``F.grid_sample(padding_mode="border",
align_corners=True)`` semantics.

Port of ``unsupervised_pose_estimation_tpu/ops/warp.py::grid_sample``: the
coordinates are clamped to the image, the 2x2 patch start to [0, W-2] x
[0, H-2], and the lerp weights are taken against that start. This is the
plain version; the CUDA warp kernel and its twin live in
``ops.kernels.warp``.
"""

from __future__ import annotations

import torch


def unnormalize(grid_x, grid_y, height: int, width: int):
    """[-1, 1] coordinates -> clamped pixel coordinates (x, y)."""
    x = torch.clamp((grid_x + 1.0) * 0.5 * (width - 1), 0.0, width - 1)
    y = torch.clamp((grid_y + 1.0) * 0.5 * (height - 1), 0.0, height - 1)
    return x, y


def corners(image, x, y):
    """Four bilinear taps of NHWC ``image`` at pixel coordinates x, y
    (B, Ho, Wo): -> (v00, v01, v10, v11) each (B, Ho, Wo, C) float32 in the
    image's own units, plus the weights wx, wy (B, Ho, Wo, 1)."""
    b, h, w, c = image.shape
    x0 = torch.clamp(torch.floor(x), max=w - 2) if w > 1 else torch.zeros_like(x)
    y0 = torch.clamp(torch.floor(y), max=h - 2) if h > 1 else torch.zeros_like(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    flat = image.reshape(b, h * w, c)

    def take(yy, xx):
        idx = (yy * w + xx).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(*x.shape, c).float()

    return (take(y0i, x0i), take(y0i, x1i), take(y1i, x0i), take(y1i, x1i),
            wx, wy)


def grid_sample(image, grid):
    """Sample NHWC ``image`` at the planar [-1, 1] ``grid`` (B, 2, Ho, Wo);
    -> (B, Ho, Wo, C) float32 in the image's units (a uint8 image gives
    0..255 values)."""
    b, h, w, c = image.shape
    x, y = unnormalize(grid[:, 0], grid[:, 1], h, w)
    v00, v01, v10, v11, wx, wy = corners(image, x, y)
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    return top + (bot - top) * wy
