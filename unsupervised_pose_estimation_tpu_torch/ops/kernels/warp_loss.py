"""K1 / K2: fused warp + SSIM/L1 photometric loss, and its backward wrt the
warp's coordinates.

CUDA kernels: ``csrc/warp_loss.cu`` (K1) replaces the TPU kernel
``unsupervised_pose_estimation_tpu/ops/pallas/warp_loss.py::
_warp_loss_kernel_v9``: the warped frame is scored in shared memory and
never written to device memory unless the residuals are asked for.
``csrc/warp_loss_bwd.cu`` (K2) replaces that file's ``_bwd_kernel``: the
SSIM/L1 adjoint contracted with the saved coordinate-gradient planes, summed
over channels. On an H100 both are bound by bytes at B=12, C=3, 192x640: K1
moves 39.8 MB without residuals (11.9 us at 3.35 TB/s), K2 88.5 MB
(26.4 us). ``warp_reproj_loss_op`` is the differentiable op: K1 with
residuals forward, K2 backward.
"""

from __future__ import annotations

import torch

from ..warp import grid_cotangent
from . import _lib
from .reproj_loss import score_plain, ssim_l1_grads_plain
from .warp import _check as _check_warp, warp_plain


def _check(image, grid, target):
    _check_warp(image, grid)
    b, h, w, c = image.shape
    if target.dtype != torch.float32 or tuple(target.shape) != (b, c, h, w):
        raise ValueError(f"warp_reproj_loss: target must be float32 "
                         f"{(b, c, h, w)}, got {target.dtype} "
                         f"{tuple(target.shape)}")


def _check_bwd(warped, target, ddx, ddy, g):
    b, c, h, w = warped.shape
    for name, t, shape in (("target", target, (b, c, h, w)),
                           ("ddx", ddx, (b, c, h, w)),
                           ("ddy", ddy, (b, c, h, w)), ("g", g, (b, h, w))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"warp_reproj_loss_bwd: {name} must be float32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if warped.dtype != torch.float32 or h < 2 or w < 2:
        raise ValueError("warp_reproj_loss_bwd: warped must be float32, at "
                         "least 2x2")


def warp_reproj_loss_plain(image, grid, target, residuals: bool = False):
    """Plain PyTorch version of the kernel: image (B, H, W, C) uint8, planar
    grid (B, 2, H, W), planar float32 target (B, C, H, W) -> loss
    (B, H, W, 1) of the warped image against the target, plus
    (warped, ddx, ddy) planar (B, C, H, W) with ``residuals``."""
    _check(image, grid, target)
    warped, ddx, ddy = warp_plain(image, grid)
    loss = score_plain(warped, target)[..., None]
    return (loss, warped, ddx, ddy) if residuals else loss


def warp_reproj_loss(image, grid, target, residuals: bool = False):
    """The op of :func:`warp_reproj_loss_plain`: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(image, grid, target)
    if not _lib.on_cuda("warp_reproj_loss", image, grid, target):
        return warp_reproj_loss_plain(image, grid, target, residuals)
    b, h, w, c = image.shape
    dev = image.device
    loss = torch.empty((b, h, w, 1), dtype=torch.float32, device=dev)
    res = tuple(torch.empty((b, c, h, w), dtype=torch.float32, device=dev)
                for _ in range(3)) if residuals else ()
    ptrs = [t.data_ptr() for t in res] if residuals else [None] * 3
    with torch.cuda.device(dev):
        _lib.launch("warp_reproj_loss", "upe_warp_reproj_loss",
                    image.data_ptr(), grid.data_ptr(), target.data_ptr(),
                    loss.data_ptr(), *ptrs, b, h, w, c, _lib.stream_of(image))
    return (loss, *res) if residuals else loss


def warp_reproj_loss_bwd_plain(warped, target, ddx, ddy, g):
    """Plain PyTorch version of the backward kernel: K1's residuals
    (warped, ddx, ddy) and the target, planar (B, C, H, W) float32, and the
    upstream gradient g (B, H, W) -> (gx, gy) (B, H, W), the cotangents of
    the clamped pixel coordinates: sum over channels, in channel order, of
    dL/dwarped * ddx (resp. ddy)."""
    _check_bwd(warped, target, ddx, ddy, g)
    gp = ssim_l1_grads_plain(warped, target, g, with_target=False)[0]
    gx = gp[:, 0] * ddx[:, 0]
    gy = gp[:, 0] * ddy[:, 0]
    for ch in range(1, gp.shape[1]):
        gx = gx + gp[:, ch] * ddx[:, ch]
        gy = gy + gp[:, ch] * ddy[:, ch]
    return gx, gy


def warp_reproj_loss_bwd(warped, target, ddx, ddy, g):
    """The backward of :func:`warp_reproj_loss_bwd_plain`: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    _check_bwd(warped, target, ddx, ddy, g)
    if not _lib.on_cuda("warp_reproj_loss_bwd", warped, target, ddx, ddy, g):
        return warp_reproj_loss_bwd_plain(warped, target, ddx, ddy, g)
    b, c, h, w = warped.shape
    gx, gy = (torch.empty_like(g) for _ in range(2))
    with torch.cuda.device(warped.device):
        _lib.launch("warp_reproj_loss_bwd", "upe_warp_reproj_loss_bwd",
                    warped.data_ptr(), target.data_ptr(), ddx.data_ptr(),
                    ddy.data_ptr(), g.data_ptr(), gx.data_ptr(),
                    gy.data_ptr(), b, c, h, w, _lib.stream_of(warped))
    return gx, gy


class WarpReprojLoss(torch.autograd.Function):
    """K1 forward with its residual planes saved, K2 backward (the JAX
    package's custom_vjp of ``warp_reproj_loss``). Only the grid gets a
    gradient: image and target are input frames."""

    @staticmethod
    def forward(ctx, image, grid, target):
        loss, warped, ddx, ddy = warp_reproj_loss(image, grid, target,
                                                  residuals=True)
        ctx.save_for_backward(grid, target, warped, ddx, ddy)
        return loss

    @staticmethod
    def backward(ctx, grad):
        grid, target, warped, ddx, ddy = ctx.saved_tensors
        gx, gy = warp_reproj_loss_bwd(warped, target, ddx, ddy,
                                      grad[..., 0].contiguous())
        return None, grid_cotangent(grid, gx, gy), None


def warp_reproj_loss_op(image, grid, target):
    """Differentiable :func:`warp_reproj_loss` (no residuals): through
    :class:`WarpReprojLoss` when the grid's gradient is recorded, else the
    forward wrapper alone."""
    if torch.is_grad_enabled() and grid.requires_grad:
        return WarpReprojLoss.apply(image, grid, target)
    return warp_reproj_loss(image, grid, target)
