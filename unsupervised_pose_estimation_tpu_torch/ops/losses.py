"""Loss primitives: SSIM, photometric reprojection, edge-aware smoothness,
min-reprojection automasking and the GAN prior's log losses.

Port of ``unsupervised_pose_estimation_tpu/ops/losses.py`` (the terms the
validation step uses). Layouts are the reference's: planar (N, C, H, W)
inputs for the reprojection terms, NHWC for smoothness. These are the plain
versions; ``ops.kernels`` holds the CUDA kernels that the step runs on a
CUDA device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SSIM_C1 = 0.01 ** 2
_SSIM_C2 = 0.03 ** 2


def _win3(x):
    """3x3 stride-1 window sum over the last two dims (rows, then
    columns)."""
    rows = x[..., 0:-2, :] + x[..., 1:-1, :] + x[..., 2:, :]
    return rows[..., 0:-2] + rows[..., 1:-1] + rows[..., 2:]


def _ssim_planar(x, y):
    """SSIM dissimilarity clamp((1 - SSIM) / 2, 0, 1) of planar
    (N, C, H, W) inputs, 3x3 box moments with reflect padding."""
    x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    y = F.pad(y, (1, 1, 1, 1), mode="reflect")
    ninth = 1.0 / 9.0
    mu_x = _win3(x) * ninth
    mu_y = _win3(y) * ninth
    sigma_x = _win3(x * x) * ninth - mu_x * mu_x
    sigma_y = _win3(y * y) * ninth - mu_y * mu_y
    sigma_xy = _win3(x * y) * ninth - mu_x * mu_y
    ssim_n = (2.0 * mu_x * mu_y + _SSIM_C1) * (2.0 * sigma_xy + _SSIM_C2)
    ssim_d = (mu_x * mu_x + mu_y * mu_y + _SSIM_C1) * (
        sigma_x + sigma_y + _SSIM_C2)
    return torch.clamp((1.0 - ssim_n / ssim_d) * 0.5, 0.0, 1.0)


def reprojection_loss_planar(p, t, use_ssim: bool = True):
    """Per-pixel 0.85 * SSIM + 0.15 * L1, channel-meaned (pure L1 without
    ``use_ssim``): planar (N, C, H, W) -> (N, H, W, 1)."""
    l1 = torch.mean(torch.abs(t - p), dim=1)
    if not use_ssim:
        return l1[..., None]
    ssim_term = torch.mean(_ssim_planar(p, t), dim=1)
    return (0.85 * ssim_term + 0.15 * l1)[..., None]


def smooth_loss(disp, img):
    """Edge-aware first-order smoothness of NHWC ``disp`` (B, H, W, 1)
    against the edges of NHWC ``img``; a scalar."""
    grad_disp_x = torch.abs(disp[:, :, :-1, :] - disp[:, :, 1:, :])
    grad_disp_y = torch.abs(disp[:, :-1, :, :] - disp[:, 1:, :, :])
    grad_img_x = torch.mean(torch.abs(img[:, :, :-1, :] - img[:, :, 1:, :]),
                            dim=-1, keepdim=True)
    grad_img_y = torch.mean(torch.abs(img[:, :-1, :, :] - img[:, 1:, :, :]),
                            dim=-1, keepdim=True)
    grad_disp_x = grad_disp_x * torch.exp(-grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-grad_img_y)
    return torch.mean(grad_disp_x) + torch.mean(grad_disp_y)


def normalized_disp(disp, eps: float = 1e-7):
    """NHWC disparity over its per-image spatial mean."""
    return disp / (torch.mean(disp, dim=(1, 2), keepdim=True) + eps)


def min_reprojection(reproj, identity_reproj, noise=None, generator=None,
                     avg_reprojection: bool = False):
    """Min over sources with identity automasking.

    reproj, identity_reproj: (B, H, W, S); identity_reproj None disables
    automasking. The identity losses get the reference's 1e-5 * N(0, 1)
    tie-break: ``noise`` is that term as given (tests pass the JAX
    package's draw), else it is drawn from ``generator``.

    Returns (to_optimise (B, H, W), automask (B, H, W) or None), automask
    being 1 where a warped source won the min.
    """
    if avg_reprojection:
        reproj = torch.mean(reproj, dim=-1, keepdim=True)
    if identity_reproj is None:
        if reproj.shape[-1] == 1:
            return reproj[..., 0], None
        return torch.amin(reproj, dim=-1), None
    if avg_reprojection:
        identity_reproj = torch.mean(identity_reproj, dim=-1, keepdim=True)
    if noise is None:
        noise = torch.randn(identity_reproj.shape, generator=generator,
                            device=identity_reproj.device) * 1e-5
    identity_reproj = identity_reproj + noise
    combined = torch.cat([identity_reproj, reproj], dim=-1)
    # amin splits a tie's gradient evenly, as jnp.min does (torch.min's
    # values send all of it to one index); argmin picks the automask
    to_optimise = torch.amin(combined, dim=-1)
    idxs = torch.argmin(combined, dim=-1)
    automask = (idxs > identity_reproj.shape[-1] - 1).to(reproj.dtype)
    return to_optimise, automask


def silog_loss(fake, real):
    """Scale-invariant log loss of a prediction ``real`` against the
    pseudo-disparity prior ``fake`` (same shape), a scalar: pixels where
    either is <= 0 are set to 1 in both (a log difference of 0), N counts
    the pixels where ``real`` > 0, clamped at 1, and the loss is
    sqrt(sum(d^2) / N - (sum(d) / N)^2) of d = log(real) - log(fake)."""
    n = torch.clamp((real > 0).to(real.dtype).sum(), min=1.0)
    invalid = (real <= 0) | (fake <= 0)
    one = torch.ones((), dtype=real.dtype, device=real.device)
    d = (torch.log(torch.where(invalid, one, real))
         - torch.log(torch.where(invalid, one, fake)))
    return torch.sqrt(torch.sum(d * d) / n - (torch.sum(d) / n) ** 2)


def rmse_log_loss(fake, real, eps: float = 1e-8):
    """Log-RMSE over the pixels where ``real`` < 1 (N clamped at 1), a
    scalar, with ``fake`` offset by ``eps`` and both floored at ``eps``
    inside the logs."""
    mask = real < 1.0
    n = torch.clamp(mask.to(real.dtype).sum(), min=1.0)
    fake = fake + eps
    d = torch.where(mask, torch.log(torch.clamp(real, min=eps))
                    - torch.log(torch.clamp(fake, min=eps)),
                    torch.zeros((), dtype=real.dtype, device=real.device))
    return torch.sqrt(torch.sum(d * d) / n)
