"""K3: per-pixel SSIM + L1 photometric loss of two planar images.

CUDA kernel: ``csrc/reproj_loss.cu``. It replaces the TPU kernel
``unsupervised_pose_estimation_tpu/ops/pallas/reproj_loss.py::_kernel``.
On an H100 it is bound by bytes: 41.3 MB at B=12, C=3, 192x640, 12.3 us at
3.35 TB/s.
"""

from __future__ import annotations

import torch

from ..losses import _ssim_planar
from . import _lib


def _check(pred, target):
    if pred.dtype != torch.float32 or target.dtype != torch.float32:
        raise TypeError("reproj_loss: inputs must be float32")
    if pred.dim() != 4 or pred.shape != target.shape:
        raise ValueError(f"reproj_loss: need two (B, C, H, W) inputs, got "
                         f"{tuple(pred.shape)} and {tuple(target.shape)}")
    if pred.shape[2] < 2 or pred.shape[3] < 2:
        raise ValueError("reproj_loss: planes must be at least 2x2")


def score_plain(pred, target):
    """The kernel's arithmetic: sum over channels of
    (0.85 * SSIM + 0.15 * L1) / C, in channel order -> (B, H, W)."""
    inv_c = 1.0 / pred.shape[1]
    part = (0.85 * _ssim_planar(pred, target)
            + 0.15 * torch.abs(target - pred)) * inv_c
    acc = part[:, 0]
    for ch in range(1, part.shape[1]):
        acc = acc + part[:, ch]
    return acc


def reproj_loss_plain(pred, target):
    """Plain PyTorch version of the kernel: planar (B, C, H, W) float32
    prediction and target -> (B, H, W, 1) per-pixel
    0.85 * clamp((1 - SSIM) / 2, 0, 1) + 0.15 * |t - p|, channel-meaned,
    with 3x3 reflect-padded SSIM windows."""
    _check(pred, target)
    return score_plain(pred, target)[..., None]


def reproj_loss(pred, target):
    """The loss of :func:`reproj_loss_plain`: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(pred, target)
    if not _lib.on_cuda("reproj_loss", pred, target):
        return reproj_loss_plain(pred, target)
    b, c, h, w = pred.shape
    out = torch.empty((b, h, w, 1), dtype=torch.float32, device=pred.device)
    with torch.cuda.device(pred.device):
        _lib.launch("reproj_loss", "upe_reproj_loss", pred.data_ptr(),
                    target.data_ptr(), out.data_ptr(), b, c, h, w,
                    _lib.stream_of(pred))
    return out
