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


def _clip(u, hi: float):
    """clip(u, 0, hi) as ``jnp.clip`` differentiates it: gradient 1 inside,
    0 outside and 0.5 exactly at a bound (``torch.clamp`` gives 1 there)."""
    lo_t = torch.zeros((), dtype=u.dtype, device=u.device)
    hi_t = torch.full((), hi, dtype=u.dtype, device=u.device)
    return torch.minimum(torch.maximum(u, lo_t), hi_t)


def clip_grad(u, hi: float):
    """d clip(u, 0, hi) / du with :func:`_clip`'s convention, for the
    kernels' hand-written backward passes."""
    inside = ((u > 0.0) & (u < hi)).to(u.dtype)
    bound = ((u == 0.0) | (u == hi)).to(u.dtype)
    return inside + 0.5 * bound


def unnormalize(grid_x, grid_y, height: int, width: int):
    """[-1, 1] coordinates -> clamped pixel coordinates (x, y)."""
    x = _clip((grid_x + 1.0) * 0.5 * (width - 1), width - 1)
    y = _clip((grid_y + 1.0) * 0.5 * (height - 1), height - 1)
    return x, y


def grid_cotangent(grid, gx, gy):
    """Cotangent of the planar [-1, 1] grid (B, 2, H, W) from the
    cotangents gx, gy (B, H, W) of the clamped pixel coordinates, as JAX's
    autodiff of ``unnormalize`` gives it."""
    _, _, h, w = grid.shape
    out = []
    for g, coord, n in ((gx, grid[:, 0], w), (gy, grid[:, 1], h)):
        u = (coord + 1.0) * 0.5 * (n - 1)
        out.append(g * clip_grad(u, n - 1) * (0.5 * (n - 1)))
    return torch.stack(out, 1)


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
