"""Pose regression decoder.

Port of ``unsupervised_pose_estimation_tpu/models/pose_decoder.py``: one 1x1
squeeze conv shared by every input feature stack, concat, two 3x3 convs with
ReLU, a 1x1 conv to 6 numbers per frame, the spatial mean, times 0.01.
Layout: the reference ``net`` ModuleList (squeeze, pose_0, pose_1, pose_2).
Under a ``compute_dtype`` the convs run at it and the mean is taken in
float32, so poses are float32 at any compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, widen


class PoseDecoder(nn.Module):
    def __init__(self, num_ch_enc_last: int = 512,
                 num_input_features: int = 1,
                 num_frames_to_predict_for: int = 2,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_frames = num_frames_to_predict_for
        dt = compute_dtype
        self.net = nn.ModuleList([
            Conv2d(num_ch_enc_last, 256, 1, compute_dtype=dt),
            Conv2d(num_input_features * 256, 256, 3, 1, 1, compute_dtype=dt),
            Conv2d(256, 256, 3, 1, 1, compute_dtype=dt),
            Conv2d(256, 6 * num_frames_to_predict_for, 1, compute_dtype=dt),
        ])

    def forward(self, input_features):
        """input_features: a list of encoder pyramids -> (axisangle,
        translation), each (B, frames, 1, 3)."""
        x = torch.cat([F.relu(self.net[0](f[-1])) for f in input_features],
                      1)
        x = F.relu(self.net[1](x))
        x = F.relu(self.net[2](x))
        x = widen(self.net[3](x)).mean(dim=(2, 3))
        x = 0.01 * x.reshape(-1, self.num_frames, 1, 6)
        return x[..., :3], x[..., 3:]
