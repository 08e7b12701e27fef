"""Standalone pose network: SfMLearner's PoseCNN.

Port of ``unsupervised_pose_estimation_tpu/models/pose_cnn.py``: seven
stride-2 convs with zero padding, each followed by ReLU, over the
channel-concatenated frames, a 1x1 pose conv, the spatial mean, times 0.01.
Layout: the reference ``net`` ModuleList (``net.0-6``) and ``pose_conv``.
Under a ``compute_dtype`` the convs run at it and the mean is taken in
float32, so poses are float32 at any compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, widen

# (out channels, kernel, padding) per conv; every one has stride 2
SPECS = ((16, 7, 3), (32, 5, 2), (64, 3, 1), (128, 3, 1),
         (256, 3, 1), (256, 3, 1), (256, 3, 1))


class PoseCNN(nn.Module):
    def __init__(self, num_input_frames: int = 2,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_input_frames = num_input_frames
        self.num_frames = num_input_frames - 1
        cin, convs = 3 * num_input_frames, []
        for cout, k, p in SPECS:
            convs.append(Conv2d(cin, cout, k, 2, p,
                                compute_dtype=compute_dtype))
            cin = cout
        self.net = nn.ModuleList(convs)
        self.pose_conv = Conv2d(cin, 6 * self.num_frames, 1,
                                compute_dtype=compute_dtype)

    def forward(self, x):
        """x: (B, 3 * num_input_frames, H, W) -> (axisangle, translation),
        each (B, num_input_frames - 1, 1, 3)."""
        for conv in self.net:
            x = F.relu(conv(x))
        x = widen(self.pose_conv(x)).mean(dim=(2, 3))
        x = 0.01 * x.reshape(-1, self.num_frames, 1, 6)
        return x[..., :3], x[..., 3:]
