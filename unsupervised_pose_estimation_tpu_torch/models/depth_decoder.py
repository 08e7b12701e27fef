"""U-Net disparity decoder, the fork's deconv + BatchNorm variant.

Port of ``unsupervised_pose_estimation_tpu/models/depth_decoder.py``
(``variant="fork"``): for each level i = 4..0, ConvBlock, 2x transposed
conv, concat the encoder skip, ConvBlock, BatchNorm, and a sigmoid
disparity head at the requested scales. As in the reference package the
BatchNorms are registered modules (the original fork left them out of the
state_dict). Layout: the fork's ``decoder`` ModuleList (5 deconvs for
i = 4..0, then the two ConvBlocks per level, then the disparity heads by
scale) plus ``bn.{i}``. Under a ``compute_dtype`` the encoder features are
cast to it and every layer runs at it; the sigmoid takes the head's output
in float32, so disparities are float32 at any compute dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import BatchNorm2d, Conv3x3, ConvBlock, Deconv2x, cast, widen

NUM_CH_DEC = (16, 32, 64, 128, 256)


class DepthDecoder(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int] = (64, 64, 128, 256, 512),
                 scales: Tuple[int, ...] = (0, 1, 2, 3),
                 num_output_channels: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scales = tuple(sorted(scales))
        self.compute_dtype = dt = compute_dtype
        mods = [Deconv2x(NUM_CH_DEC[i], dt) for i in range(4, -1, -1)]
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            mods.append(ConvBlock(cin, NUM_CH_DEC[i], dt))
            skip = num_ch_enc[i - 1] if i > 0 else 0
            mods.append(ConvBlock(NUM_CH_DEC[i] + skip, NUM_CH_DEC[i], dt))
        for s in self.scales:
            mods.append(Conv3x3(NUM_CH_DEC[s], num_output_channels, dt))
        self.decoder = nn.ModuleList(mods)
        self.bn = nn.ModuleList(BatchNorm2d(c, dt) for c in NUM_CH_DEC)

    def forward(self, features) -> Dict[int, torch.Tensor]:
        """features: the encoder pyramid (NCHW) -> {scale: (B, 1, h, w)
        sigmoid disparity}."""
        out = {}
        dt = self.compute_dtype
        x = cast(features[-1], dt)
        for j, i in enumerate(range(4, -1, -1)):
            x = self.decoder[5 + 2 * j](x)
            x = self.decoder[j](x)
            if i > 0:
                x = torch.cat([x, cast(features[i - 1], dt)], 1)
            x = self.bn[i](self.decoder[5 + 2 * j + 1](x))
            if i in self.scales:
                head = self.decoder[15 + self.scales.index(i)]
                out[i] = torch.sigmoid(widen(head(x)))
        return out
