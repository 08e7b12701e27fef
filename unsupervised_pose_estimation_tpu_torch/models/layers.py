"""Building blocks: reflect-padded 3x3 conv, conv + ELU, the fork's 2x
transposed conv, and BatchNorm with flax's train-mode semantics.

Port of ``unsupervised_pose_estimation_tpu/models/layers.py`` in its plain
layout; the TPU's packed (space-to-depth) forms of the same parameters are
not reproduced. Parameter names follow the reference ``.pth`` layout
(``conv.conv.weight`` for a ConvBlock).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def reflect_pad1(x):
    """Reflection pad of 1 on H and W with numpy's rule for an axis of one
    element, which repeats it (torch's reflect pad refuses that axis; the
    deepest feature map of a 32-row input has one row). Where both axes have
    more than one element it is the one-call reflect pad, whose backward
    keeps no padded intermediate."""
    if x.shape[-1] > 1 and x.shape[-2] > 1:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    for pad, n in (((1, 1, 0, 0), x.shape[-1]), ((0, 0, 1, 1), x.shape[-2])):
        x = F.pad(x, pad, mode="reflect" if n > 1 else "replicate")
    return x


class Conv3x3(nn.Module):
    """Reflection-pad(1) + 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3)

    def forward(self, x):
        return self.conv(reflect_pad1(x))


class ConvBlock(nn.Module):
    """Conv3x3 + ELU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels)

    def forward(self, x):
        return F.elu(self.conv(x))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` as the reference's flax ``nn.BatchNorm(momentum=
    0.9, epsilon=1e-5)`` trains: it normalises with the biased batch
    variance (as torch does) and also updates ``running_var`` with it (torch
    uses the unbiased one there). In eval mode it is ``nn.BatchNorm2d``.
    Parameters and buffers keep ``nn.BatchNorm2d``'s names."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias,
                           training=True, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1.0 - m) * self.running_var + m * var)
            self.num_batches_tracked.add_(1)
        return out


def Deconv2x(channels: int) -> nn.ConvTranspose2d:
    """The fork decoder's exact 2x upsampling: k=3, stride 2, padding 1,
    output_padding 1."""
    return nn.ConvTranspose2d(channels, channels, 3, stride=2, padding=1,
                              output_padding=1)


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
