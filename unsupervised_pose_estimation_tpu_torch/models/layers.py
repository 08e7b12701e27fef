"""Building blocks: reflect-padded 3x3 conv, conv + ELU, the fork's 2x
transposed conv, BatchNorm with flax's train-mode semantics, and the
CycleGAN networks' instance normalisation.

Port of ``unsupervised_pose_estimation_tpu/models/layers.py`` in its plain
layout; the TPU's packed (space-to-depth) forms of the same parameters are
not reproduced. Parameter names follow the reference ``.pth`` layout
(``conv.conv.weight`` for a ConvBlock).

``compute_dtype`` is the reference's ``dtype=compute_dtype``: a conv casts
its input, weight and bias to it, a BatchNorm returns it; parameters and
BatchNorm statistics stay float32. ``None`` (a float32 run) casts nothing,
so the modules also run in the dtype they are moved to (float64 checks).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def cast(x, dtype: Optional[torch.dtype]):
    """``x`` in ``dtype``; None leaves it as it is."""
    return x if dtype is None else x.to(dtype)


def widen(x):
    """A bfloat16 result in float32 (the reference's ``astype(float32)``
    before the disparity sigmoid and the pose mean); any other dtype as it
    is."""
    return x.float() if x.dtype == torch.bfloat16 else x


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs at ``compute_dtype`` (flax ``nn.Conv(dtype=
    ...)``): input, weight and bias cast to it."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class _ReflectPad1(torch.autograd.Function):
    """Reflection pad of 1 on H and W whose backward sums in a fixed order.
    torch's CUDA backward of a reflect pad adds the border rows and columns
    into the input's gradient with atomics, so two runs of the same step
    differ in the last bits (on the H100 every repeat did); this backward
    takes the interior and adds the two reflected rows, then the two
    reflected columns (corners included), one slice at a time."""

    @staticmethod
    def forward(ctx, x):
        ctx.hw = x.shape[-2:]
        if x.shape[-1] > 1 and x.shape[-2] > 1:
            return F.pad(x, (1, 1, 1, 1), mode="reflect")
        for pad, n in (((1, 1, 0, 0), x.shape[-1]),
                       ((0, 0, 1, 1), x.shape[-2])):
            x = F.pad(x, pad, mode="reflect" if n > 1 else "replicate")
        return x

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.hw
        gx = g[..., 1:-1, 1:-1].clone()
        # the input row (column) that padded row 0 and row h + 1 repeat
        top, bottom = (1, h - 2) if h > 1 else (0, 0)
        left, right = (1, w - 2) if w > 1 else (0, 0)
        gx[..., top, :] += g[..., 0, 1:-1]
        gx[..., bottom, :] += g[..., -1, 1:-1]
        for col, src in ((left, 0), (right, -1)):
            gx[..., :, col] += g[..., 1:-1, src]
            gx[..., top, col] += g[..., 0, src]
            gx[..., bottom, col] += g[..., -1, src]
        return gx


def reflect_pad1(x):
    """Reflection pad of 1 on H and W with numpy's rule for an axis of one
    element, which repeats it (torch's reflect pad refuses that axis; the
    deepest feature map of a 32-row input has one row). Its backward is
    deterministic (``_ReflectPad1``)."""
    return _ReflectPad1.apply(x)


class Conv3x3(nn.Module):
    """Reflection-pad(1) + 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3,
                           compute_dtype=compute_dtype)

    def forward(self, x):
        return self.conv(reflect_pad1(x))


class ConvBlock(nn.Module):
    """Conv3x3 + ELU."""

    def __init__(self, in_channels: int, out_channels: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels, compute_dtype)

    def forward(self, x):
        return F.elu(self.conv(x))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` as the reference's flax ``nn.BatchNorm(momentum=
    0.9, epsilon=1e-5)`` trains: it normalises with the biased batch
    variance (as torch does) and also updates ``running_var`` with it (torch
    uses the unbiased one there). In eval mode it is ``nn.BatchNorm2d``.
    Parameters and buffers keep ``nn.BatchNorm2d``'s names. Under a
    bfloat16 ``compute_dtype`` it is flax's ``BatchNorm(dtype=bfloat16)``:
    statistics formed in float32, the input normalised in float32 and the
    result rounded once to bfloat16."""

    def __init__(self, num_features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(num_features)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if not self.training:
            return cast(super().forward(x), self.compute_dtype)
        out = F.batch_norm(x, None, None, self.weight, self.bias,
                           training=True, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(widen(x), dim=(0, 2, 3),
                                       unbiased=False)
            m = self.momentum
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1.0 - m) * self.running_var + m * var)
            self.num_batches_tracked.add_(1)
        return cast(out, self.compute_dtype)


def instance_norm(x, eps: float = 1e-5):
    """Per-sample, per-channel normalisation of NCHW ``x`` over space, with
    no affine and no running statistics (torch ``InstanceNorm2d``'s
    defaults), as the reference's ``instance_norm``: the mean and the
    biased variance are summed in float32 and rounded to ``x``'s dtype
    (``jnp.mean`` and ``jnp.var`` of a bfloat16 array), then ``(x - mean) *
    rsqrt(var + eps)`` is taken in that dtype. Plain tensor ops, whose
    backward on the card sums in a fixed order."""
    var, mean = torch.var_mean(widen(x), dim=(2, 3), keepdim=True,
                               unbiased=False)
    mean, var = mean.to(x.dtype), var.to(x.dtype)
    return (x - mean) * torch.rsqrt(var + eps)


class Deconv2x(nn.ConvTranspose2d):
    """The fork decoder's exact 2x upsampling: k=3, stride 2, padding 1,
    output_padding 1, at ``compute_dtype`` as ``Conv2d``."""

    def __init__(self, channels: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(channels, channels, 3, stride=2, padding=1,
                         output_padding=1)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator,
                 fan_out_convs: bool = False) -> None:
    """Seeded initialisation in place: conv and transposed-conv weights
    normal with variance 2 / fan_out (``fan_out_convs``, the ResNet's
    kaiming init) or 1 / fan_in, biases 0, BatchNorm at identity."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            k = w.shape[2] * w.shape[3]
            if isinstance(m, nn.ConvTranspose2d):
                fan_in, fan_out = w.shape[0] * k, w.shape[1] * k
            else:
                fan_in, fan_out = w.shape[1] * k, w.shape[0] * k
            std = math.sqrt(2.0 / fan_out if fan_out_convs else 1.0 / fan_in)
            w.copy_(torch.randn(w.shape, generator=generator) * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
