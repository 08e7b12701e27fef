"""K5: bilinear warp of a uint8 frame plus its coordinate-gradient planes.

CUDA kernel: ``csrc/warp.cu``. It replaces the TPU kernel
``unsupervised_pose_estimation_tpu/ops/pallas/warp_kernel.py::
_warp_lerp_kernel_v8`` and the corner-fetch rungs that back it up under
large motion. On an H100 it is bound by bytes: 69.3 MB at B=12, C=3,
192x640, 20.7 us at 3.35 TB/s. ``warp_op`` is the differentiable warp: K5
forward, and a backward in plain PyTorch that contracts the upstream
gradient with the ddx / ddy planes, as the JAX package's XLA backward of
K5 does (it has no backward kernel to port).
"""

from __future__ import annotations

import torch

from ..warp import corners, grid_cotangent, unnormalize
from . import _lib

INV255 = 1.0 / 255.0


def _check(image, grid):
    b, h, w, _ = image.shape
    if image.dtype != torch.uint8:
        raise TypeError(f"warp: image must be uint8, got {image.dtype}")
    if grid.dtype != torch.float32 or tuple(grid.shape) != (b, 2, h, w):
        raise ValueError(f"warp: grid must be float32 {(b, 2, h, w)}, got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    if h < 2 or w < 2:
        raise ValueError("warp: image must be at least 2x2")


def lerp_planes(image, grid):
    """The warp's arithmetic on NHWC float corners -> (warped, ddx, ddy),
    each (B, H, W, C) in [0, 1] units."""
    _, h, w, _ = image.shape
    x, y = unnormalize(grid[:, 0], grid[:, 1], h, w)
    v00, v01, v10, v11, wx, wy = corners(image, x, y)
    dtop = v01 - v00
    dbot = v11 - v10
    top = v00 + wx * dtop
    bot = v10 + wx * dbot
    warped = (top + wy * (bot - top)) * INV255
    ddx = (dtop + wy * (dbot - dtop)) * INV255
    ddy = (bot - top) * INV255
    return warped, ddx, ddy


def warp_plain(image, grid):
    """Plain PyTorch version of the kernel: image (B, H, W, C) uint8, planar
    grid (B, 2, H, W) in [-1, 1] (border, align_corners=True) -> warped,
    d warped / d x and d warped / d y, each planar (B, C, H, W) float32 in
    [0, 1] units (the lerp runs on raw 0..255 values and is scaled last)."""
    _check(image, grid)
    return tuple(t.permute(0, 3, 1, 2).contiguous()
                 for t in lerp_planes(image, grid))


def warp(image, grid):
    """The warp of :func:`warp_plain`: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    _check(image, grid)
    if not _lib.on_cuda("warp", image, grid):
        return warp_plain(image, grid)
    b, h, w, c = image.shape
    warped, ddx, ddy = (torch.empty((b, c, h, w), dtype=torch.float32,
                                    device=image.device) for _ in range(3))
    with torch.cuda.device(image.device):
        _lib.launch("warp", "upe_warp", image.data_ptr(), grid.data_ptr(),
                    warped.data_ptr(), ddx.data_ptr(), ddy.data_ptr(),
                    b, h, w, c, _lib.stream_of(image))
    return warped, ddx, ddy


class Warp(torch.autograd.Function):
    """K5 forward; backward gx = sum_c g * ddx, gy = sum_c g * ddy, then
    through the coordinate clamp to the grid. The image gets no gradient
    (the JAX package's ``_sample_planar`` custom_vjp)."""

    @staticmethod
    def forward(ctx, image, grid):
        warped, ddx, ddy = warp(image, grid)
        ctx.save_for_backward(grid, ddx, ddy)
        ctx.mark_non_differentiable(ddx, ddy)
        return warped, ddx, ddy

    @staticmethod
    def backward(ctx, grad, _grad_ddx, _grad_ddy):
        grid, ddx, ddy = ctx.saved_tensors
        gx = torch.sum(grad * ddx, dim=1)
        gy = torch.sum(grad * ddy, dim=1)
        return None, grid_cotangent(grid, gx, gy)


def warp_op(image, grid):
    """Differentiable :func:`warp` (gradient to the grid only): K5
    forward, a plain-torch backward."""
    return Warp.apply(image, grid)
