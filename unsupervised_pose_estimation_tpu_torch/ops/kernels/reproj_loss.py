"""K3 / K4: per-pixel SSIM + L1 photometric loss of two planar images, and
its backward.

CUDA kernels: ``csrc/reproj_loss.cu`` (K3, forward) replaces the TPU kernel
``unsupervised_pose_estimation_tpu/ops/pallas/reproj_loss.py::_kernel``;
``csrc/reproj_loss_bwd.cu`` (K4, backward) replaces its ``_bwd_kernel``.
Both run on the 32 x 16 tile of ``csrc/common.cuh`` with every channel
staged at once (1-4 channels). K4 writes the target's gradient only when
asked (``with_target``): the training step's targets are input frames. On
an H100 both are bound by bytes at B=12, C=3, 192x640: K3 moves 41.3 MB
(12.3 us at 3.35 TB/s), K4 59.0 MB (17.6 us), or 76.7 MB (22.9 us) with
the target's gradient. ``reproj_loss_op`` is the differentiable op: K3
forward, K4 backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..losses import _SSIM_C1, _SSIM_C2, _ssim_planar, _win3
from . import _lib


def _check(pred, target):
    if pred.dtype != torch.float32 or target.dtype != torch.float32:
        raise TypeError("reproj_loss: inputs must be float32")
    if pred.dim() != 4 or pred.shape != target.shape:
        raise ValueError(f"reproj_loss: need two (B, C, H, W) inputs, got "
                         f"{tuple(pred.shape)} and {tuple(target.shape)}")
    if pred.shape[2] < 2 or pred.shape[3] < 2:
        raise ValueError("reproj_loss: planes must be at least 2x2")


def _check_grad(g, pred):
    b, _, h, w = pred.shape
    if g.dtype != torch.float32 or tuple(g.shape) != (b, h, w):
        raise ValueError(f"reproj_loss backward: g must be float32 "
                         f"{(b, h, w)}, got {g.dtype} {tuple(g.shape)}")


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
    _lib.check_channels("reproj_loss", c)
    out = torch.empty((b, h, w, 1), dtype=torch.float32, device=pred.device)
    with torch.cuda.device(pred.device):
        _lib.launch("reproj_loss", "upe_reproj_loss", pred.data_ptr(),
                    target.data_ptr(), out.data_ptr(), b, c, h, w,
                    _lib.stream_of(pred))
    return out


def _win3_mean(x):
    """3x3 reflect-padded window mean (rows, then columns)."""
    return _win3(F.pad(x, (1, 1, 1, 1), mode="reflect")) * (1.0 / 9.0)


def _adj3(c):
    """Adjoint of :func:`_win3_mean`: a zero-padded 3x3 sum, columns then
    rows, plus the second deposit on columns/rows 1 and n-2 from the edge
    windows that read a reflected column/row, times 1/9."""
    h, w = c.shape[-2:]
    z = F.pad(c, (1, 1))
    s = (c + z[..., :-2]) + z[..., 2:]
    s[..., 1] = s[..., 1] + c[..., 0]
    s[..., w - 2] = s[..., w - 2] + c[..., w - 1]
    z = F.pad(s, (0, 0, 1, 1))
    out = (z[..., :-2, :] + s) + z[..., 2:, :]
    out[..., 1, :] = out[..., 1, :] + s[..., 0, :]
    out[..., h - 2, :] = out[..., h - 2, :] + s[..., h - 1, :]
    return out * (1.0 / 9.0)


def ssim_l1_grads_plain(pred, target, g, with_target: bool = True):
    """The backward kernels' arithmetic: the closed-form adjoint of
    :func:`score_plain` for upstream g (B, H, W) -> (dL/dpred, dL/dtarget),
    planar (B, C, H, W) (dL/dtarget None without ``with_target``).

    dL/dp = 0.15/C g sign(p - t) + A(c_mu_p) + 2p A(c_sq) + t A(c_pt),
    with A = :func:`_adj3` and the c_* planes the derivatives of the SSIM
    term wrt the window moments, zero where the clamp of the SSIM term is
    active (the ``live`` mask of the JAX package's ``_bwd_kernel``)."""
    inv_c = 1.0 / pred.shape[1]
    p, t = pred, target
    g = g[:, None]
    mu_p = _win3_mean(p)
    mu_t = _win3_mean(t)
    sigma_p = _win3_mean(p * p) - mu_p * mu_p
    sigma_t = _win3_mean(t * t) - mu_t * mu_t
    sigma_pt = _win3_mean(p * t) - mu_p * mu_t
    n1 = 2.0 * mu_p * mu_t + _SSIM_C1
    n2 = 2.0 * sigma_pt + _SSIM_C2
    d1 = mu_p * mu_p + mu_t * mu_t + _SSIM_C1
    d2 = sigma_p + sigma_t + _SSIM_C2
    nn = n1 * n2
    dd = d1 * d2
    raw = (1.0 - nn / dd) * 0.5
    live = (raw > 0.0) & (raw < 1.0)
    gl = torch.where(live, g * (0.85 * inv_c), 0.0)
    inv_dd = 1.0 / dd
    dl_dn = -0.5 * gl * inv_dd
    dl_dd = 0.5 * gl * nn * inv_dd * inv_dd
    a_sq = _adj3(dl_dd * d1)
    a_pt = _adj3(dl_dn * 2.0 * n1)
    l1g = (0.15 * inv_c) * g * torch.sign(p - t)
    c_mu_p = dl_dn * 2.0 * mu_t * (n2 - n1) + dl_dd * 2.0 * mu_p * (d2 - d1)
    gp = l1g + _adj3(c_mu_p) + 2.0 * p * a_sq + t * a_pt
    if not with_target:
        return gp, None
    c_mu_t = dl_dn * 2.0 * mu_p * (n2 - n1) + dl_dd * 2.0 * mu_t * (d2 - d1)
    gt = -l1g + _adj3(c_mu_t) + 2.0 * t * a_sq + p * a_pt
    return gp, gt


def reproj_loss_bwd_plain(pred, target, g, with_target: bool = True):
    """Plain PyTorch version of the backward kernel: planar (B, C, H, W)
    float32 prediction and target, upstream gradient g (B, H, W) ->
    (dL/dpred, dL/dtarget), each (B, C, H, W); dL/dtarget is None without
    ``with_target``."""
    _check(pred, target)
    _check_grad(g, pred)
    return ssim_l1_grads_plain(pred, target, g, with_target)


def reproj_loss_bwd(pred, target, g, with_target: bool = True):
    """The backward of :func:`reproj_loss_bwd_plain`: the CUDA kernel for
    CUDA tensors (without ``with_target``, its instance that forms and
    writes no target gradient), the plain version for CPU tensors."""
    _check(pred, target)
    _check_grad(g, pred)
    if not _lib.on_cuda("reproj_loss_bwd", pred, target, g):
        return reproj_loss_bwd_plain(pred, target, g, with_target)
    b, c, h, w = pred.shape
    _lib.check_channels("reproj_loss_bwd", c)
    gp = torch.empty_like(pred)
    gt = torch.empty_like(pred) if with_target else None
    with torch.cuda.device(pred.device):
        _lib.launch("reproj_loss_bwd", "upe_reproj_loss_bwd",
                    pred.data_ptr(), target.data_ptr(), g.data_ptr(),
                    gp.data_ptr(), None if gt is None else gt.data_ptr(),
                    b, c, h, w, _lib.stream_of(pred))
    return gp, gt


class ReprojLoss(torch.autograd.Function):
    """K3 forward, K4 backward (the JAX package's custom_vjp of
    ``reprojection_loss_pallas_planar``). The target's gradient is formed
    only when it is recorded."""

    @staticmethod
    def forward(ctx, pred, target):
        ctx.save_for_backward(pred, target)
        return reproj_loss(pred, target)

    @staticmethod
    def backward(ctx, grad):
        pred, target = ctx.saved_tensors
        gp, gt = reproj_loss_bwd(pred, target, grad[..., 0].contiguous(),
                                 with_target=ctx.needs_input_grad[1])
        return gp if ctx.needs_input_grad[0] else None, gt


def reproj_loss_op(pred, target):
    """Differentiable :func:`reproj_loss`: K3 forward, K4 backward."""
    return ReprojLoss.apply(pred, target)
