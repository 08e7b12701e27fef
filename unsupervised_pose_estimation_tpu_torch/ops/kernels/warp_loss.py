"""K1: fused warp + SSIM/L1 photometric loss.

CUDA kernel: ``csrc/warp_loss.cu``. It replaces the TPU kernel
``unsupervised_pose_estimation_tpu/ops/pallas/warp_loss.py::
_warp_loss_kernel_v9``: the warped frame is scored in shared memory and
never written to device memory unless the residuals are asked for. On an
H100 it is bound by bytes: 39.8 MB at B=12, C=3, 192x640 without residuals,
11.9 us at 3.35 TB/s.
"""

from __future__ import annotations

import torch

from . import _lib
from .reproj_loss import score_plain
from .warp import _check as _check_warp, warp_plain


def _check(image, grid, target):
    _check_warp(image, grid)
    b, h, w, c = image.shape
    if target.dtype != torch.float32 or tuple(target.shape) != (b, c, h, w):
        raise ValueError(f"warp_reproj_loss: target must be float32 "
                         f"{(b, c, h, w)}, got {target.dtype} "
                         f"{tuple(target.shape)}")


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
