"""U-Net disparity decoder: the fork's deconv + BatchNorm variant and the
upstream monodepth2 one.

Port of ``unsupervised_pose_estimation_tpu/models/depth_decoder.py``. For
each level i = 4..0: ConvBlock, 2x upsample, concat the encoder skip,
ConvBlock, and a sigmoid head of ``num_output_channels`` at the requested
scales.

- ``variant="fork"``: the upsample is a transposed conv and a BatchNorm
  follows the second ConvBlock. As in the reference package the BatchNorms
  are registered modules (the original fork left them out of the
  state_dict). Layout: the fork's ``decoder`` ModuleList (5 deconvs for
  i = 4..0, then the two ConvBlocks per level, then the heads by scale)
  plus ``bn.{i}``.
- ``variant="upstream"``: a nearest 2x upsample and no BatchNorm. Layout:
  upstream monodepth2's ``decoder`` ModuleList, the two ConvBlocks per
  level (``decoder.0-9``), then the heads (``decoder.10+``).

Under a ``compute_dtype`` the encoder features are cast to it and every
layer runs at it; the sigmoid takes the head's output in float32, so the
outputs are float32 at any compute dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.resize import upsample2x_nearest
from .layers import BatchNorm2d, Conv3x3, ConvBlock, Deconv2x, cast, widen

NUM_CH_DEC = (16, 32, 64, 128, 256)
VARIANTS = ("fork", "upstream")


class DepthDecoder(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int] = (64, 64, 128, 256, 512),
                 scales: Tuple[int, ...] = (0, 1, 2, 3),
                 num_output_channels: int = 1,
                 compute_dtype: Optional[torch.dtype] = None,
                 variant: str = "fork"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"depth decoder variant must be one of "
                             f"{VARIANTS}, got {variant!r}")
        self.variant = variant
        self.scales = tuple(sorted(scales))
        self.compute_dtype = dt = compute_dtype
        fork = variant == "fork"
        mods = ([Deconv2x(NUM_CH_DEC[i], dt) for i in range(4, -1, -1)]
                if fork else [])
        self._convs = len(mods)
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            mods.append(ConvBlock(cin, NUM_CH_DEC[i], dt))
            skip = num_ch_enc[i - 1] if i > 0 else 0
            mods.append(ConvBlock(NUM_CH_DEC[i] + skip, NUM_CH_DEC[i], dt))
        self._heads = len(mods)
        for s in self.scales:
            mods.append(Conv3x3(NUM_CH_DEC[s], num_output_channels, dt))
        self.decoder = nn.ModuleList(mods)
        if fork:
            self.bn = nn.ModuleList(BatchNorm2d(c, dt) for c in NUM_CH_DEC)

    def forward(self, features) -> Dict[int, torch.Tensor]:
        """features: the encoder pyramid (NCHW) -> {scale: (B,
        num_output_channels, h, w) sigmoid output}."""
        out = {}
        dt = self.compute_dtype
        fork = self.variant == "fork"
        x = cast(features[-1], dt)
        for j, i in enumerate(range(4, -1, -1)):
            x = self.decoder[self._convs + 2 * j](x)
            x = self.decoder[j](x) if fork else upsample2x_nearest(x)
            if i > 0:
                x = torch.cat([x, cast(features[i - 1], dt)], 1)
            x = self.decoder[self._convs + 2 * j + 1](x)
            if fork:
                x = self.bn[i](x)
            if i in self.scales:
                head = self.decoder[self._heads + self.scales.index(i)]
                out[i] = torch.sigmoid(widen(head(x)))
        return out
