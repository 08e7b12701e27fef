"""The GAN prior's networks: the CycleGAN ResNet generator and the PatchGAN
discriminator.

Port of ``unsupervised_pose_estimation_tpu/models/cyclegan.py``, NCHW:

- ``GeneratorResNet``: reflection pad of ``channels`` and a 6x6 conv to 64,
  two stride-2 3x3 convs to 256, ``num_residual_blocks`` residual blocks,
  two nearest 2x upsamples each followed by a 3x3 conv, and a reflection
  pad of ``channels`` with a 7x7 conv of padding 2, then tanh; instance
  normalisation and ReLU after every conv but the last. The odd 6x6 kernel
  and the pad of 2 are the reference's: with one channel (the grey frame
  it is driven with) an H x W input comes back H x W. Layout: the
  reference ``.pth``'s ``model`` Sequential (``model.{i}.*``; a residual
  block's convs at ``model.{i}.block.1`` and ``.block.5``), so a reference
  file loads with ``load_state_dict``.
- ``PatchGANDiscriminator``: four stride-2 4x4 convs of padding 1 to 64,
  128, 256 and 512 channels, each followed by instance normalisation
  (not the first) and LeakyReLU(0.2), a zero pad of one row on top and one
  column on the left, and a 4x4 conv of padding 1 to one channel: an
  (H/16, W/16) patch map. Layout: the PyTorch-GAN ``model`` Sequential
  (convs at ``model.0``, ``.2``, ``.5``, ``.8`` and ``.12``).

Under a ``compute_dtype`` the input is cast to it and every layer runs at
it; the generator's tanh and the discriminator's output are float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import upsample2x_nearest
from .layers import Conv2d, cast, instance_norm


class _Lambda(nn.Module):
    """A parameter-free layer of a ``model`` Sequential, keeping the
    reference's indices."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _reflect(amount: int) -> nn.Module:
    return _Lambda(lambda x: F.pad(x, (amount,) * 4, mode="reflect"))


def _norm() -> nn.Module:
    return _Lambda(instance_norm)


class _ResidualBlock(nn.Module):
    def __init__(self, features: int, dt: Optional[torch.dtype]):
        super().__init__()
        self.block = nn.Sequential(
            _reflect(1), Conv2d(features, features, 3, compute_dtype=dt),
            _norm(), nn.ReLU(), _reflect(1),
            Conv2d(features, features, 3, compute_dtype=dt), _norm())

    def forward(self, x):
        return x + self.block(x)


class GeneratorResNet(nn.Module):
    def __init__(self, channels: int = 1, num_residual_blocks: int = 9,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dt = compute_dtype
        self.num_residual_blocks = num_residual_blocks
        layers = [_reflect(channels),
                  Conv2d(channels, 64, 6, compute_dtype=dt), _norm(),
                  nn.ReLU()]
        feat = 64
        for _ in range(2):
            layers += [Conv2d(feat, 2 * feat, 3, 2, 1, compute_dtype=dt),
                       _norm(), nn.ReLU()]
            feat *= 2
        layers += [_ResidualBlock(feat, dt)
                   for _ in range(num_residual_blocks)]
        for _ in range(2):
            layers += [_Lambda(upsample2x_nearest),
                       Conv2d(feat, feat // 2, 3, 1, 1, compute_dtype=dt),
                       _norm(), nn.ReLU()]
            feat //= 2
        layers += [_reflect(channels),
                   Conv2d(feat, channels, 7, padding=2, compute_dtype=dt),
                   _Lambda(lambda x: torch.tanh(x.float()))]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        """x: (B, channels, H, W) -> (B, channels, H, W) float32 in
        (-1, 1)."""
        return self.model(cast(x, self.compute_dtype))


class PatchGANDiscriminator(nn.Module):
    def __init__(self, channels: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dt = compute_dtype
        layers, cin = [], channels
        for i, feat in enumerate((64, 128, 256, 512)):
            layers.append(Conv2d(cin, feat, 4, 2, 1, compute_dtype=dt))
            if i > 0:  # the first block is not normalised
                layers.append(_norm())
            layers.append(nn.LeakyReLU(0.2))
            cin = feat
        layers += [_Lambda(lambda x: F.pad(x, (1, 0, 1, 0))),
                   Conv2d(cin, 1, 4, padding=1, compute_dtype=dt)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        """x: (B, channels, H, W) -> (B, 1, H / 16, W / 16) float32."""
        return self.model(cast(x, self.compute_dtype)).float()
