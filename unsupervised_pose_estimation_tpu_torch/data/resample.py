"""Nearest-neighbour resize in numpy (a copy of
``unsupervised_pose_estimation_tpu/data/resample.py``), for the KITTI
ground-truth depth maps."""

from __future__ import annotations

import numpy as np


def resize_nearest_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    rows = np.minimum((np.arange(out_h) * h / out_h).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(out_w) * w / out_w).astype(np.int64), w - 1)
    return img[rows][:, cols]
