"""K1 / K2: fused warp + SSIM/L1 photometric loss, and its backward wrt the
warp's coordinates.

CUDA kernels: ``csrc/warp_loss.cu`` (K1) replaces the TPU kernel
``unsupervised_pose_estimation_tpu/ops/pallas/warp_loss.py::
_warp_loss_kernel_v9``: the warped frame is scored in shared memory and
never written to device memory. ``csrc/warp_loss_bwd.cu`` (K2) replaces
that file's ``_bwd_kernel``: the SSIM/L1 adjoint contracted with the
coordinate-gradient planes of the warp, summed over channels. K2 rebuilds
the warp from the uint8 frame and the grid, so the forward saves no
residual planes. On an H100 both are bound by bytes at B=12, C=3, 192x640:
K1 moves 39.8 MB (11.9 us at 3.35 TB/s), K2 51.6 MB (15.4 us): the frame,
the grid, the target, the upstream gradient and the two cotangents.
``warp_reproj_loss_op`` is the differentiable op: K1 forward, K2 backward.
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


def _check_bwd(image, grid, target, g):
    _check(image, grid, target)
    b, h, w, _ = image.shape
    if g.dtype != torch.float32 or tuple(g.shape) != (b, h, w):
        raise ValueError(f"warp_reproj_loss_bwd: g must be float32 "
                         f"{(b, h, w)}, got {g.dtype} {tuple(g.shape)}")


def warp_reproj_loss_plain(image, grid, target):
    """Plain PyTorch version of the kernel: image (B, H, W, C) uint8, planar
    grid (B, 2, H, W), planar float32 target (B, C, H, W) -> loss
    (B, H, W, 1) of the warped image against the target."""
    _check(image, grid, target)
    return score_plain(warp_plain(image, grid)[0], target)[..., None]


def warp_reproj_loss(image, grid, target):
    """The op of :func:`warp_reproj_loss_plain`: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(image, grid, target)
    if not _lib.on_cuda("warp_reproj_loss", image, grid, target):
        return warp_reproj_loss_plain(image, grid, target)
    b, h, w, c = image.shape
    _lib.check_channels("warp_reproj_loss", c)
    loss = torch.empty((b, h, w, 1), dtype=torch.float32, device=image.device)
    with torch.cuda.device(image.device):
        _lib.launch("warp_reproj_loss", "upe_warp_reproj_loss",
                    image.data_ptr(), grid.data_ptr(), target.data_ptr(),
                    loss.data_ptr(), b, h, w, c, _lib.stream_of(image))
    return loss


def warp_reproj_loss_bwd_plain(image, grid, target, g):
    """Plain PyTorch version of the backward kernel: the forward's inputs
    (image (B, H, W, C) uint8, planar grid, planar float32 target) and the
    upstream gradient g (B, H, W) -> (gx, gy) (B, H, W), the cotangents of
    the clamped pixel coordinates: the warp of :func:`warp_plain` again,
    then the sum over channels, in channel order, of dL/dwarped * ddx
    (resp. ddy)."""
    _check_bwd(image, grid, target, g)
    warped, ddx, ddy = warp_plain(image, grid)
    gp = ssim_l1_grads_plain(warped, target, g, with_target=False)[0]
    gx = gp[:, 0] * ddx[:, 0]
    gy = gp[:, 0] * ddy[:, 0]
    for ch in range(1, gp.shape[1]):
        gx = gx + gp[:, ch] * ddx[:, ch]
        gy = gy + gp[:, ch] * ddy[:, ch]
    return gx, gy


def warp_reproj_loss_bwd(image, grid, target, g):
    """The backward of :func:`warp_reproj_loss_bwd_plain`: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    _check_bwd(image, grid, target, g)
    if not _lib.on_cuda("warp_reproj_loss_bwd", image, grid, target, g):
        return warp_reproj_loss_bwd_plain(image, grid, target, g)
    b, h, w, c = image.shape
    _lib.check_channels("warp_reproj_loss_bwd", c)
    gx, gy = (torch.empty_like(g) for _ in range(2))
    with torch.cuda.device(image.device):
        _lib.launch("warp_reproj_loss_bwd", "upe_warp_reproj_loss_bwd",
                    image.data_ptr(), grid.data_ptr(), target.data_ptr(),
                    g.data_ptr(), gx.data_ptr(), gy.data_ptr(), b, h, w, c,
                    _lib.stream_of(image))
    return gx, gy


class WarpReprojLoss(torch.autograd.Function):
    """K1 forward, K2 backward (the JAX package's custom_vjp of
    ``warp_reproj_loss``). It saves the forward's inputs and nothing else:
    K2 rebuilds the warp. Only the grid gets a gradient: image and target
    are input frames."""

    @staticmethod
    def forward(ctx, image, grid, target):
        ctx.save_for_backward(image, grid, target)
        return warp_reproj_loss(image, grid, target)

    @staticmethod
    def backward(ctx, grad):
        image, grid, target = ctx.saved_tensors
        gx, gy = warp_reproj_loss_bwd(image, grid, target,
                                      grad[..., 0].contiguous())
        return None, grid_cotangent(grid, gx, gy), None


def warp_reproj_loss_op(image, grid, target):
    """Differentiable :func:`warp_reproj_loss`: through
    :class:`WarpReprojLoss` when the grid's gradient is recorded, else the
    forward wrapper alone."""
    if torch.is_grad_enabled() and grid.requires_grad:
        return WarpReprojLoss.apply(image, grid, target)
    return warp_reproj_loss(image, grid, target)
