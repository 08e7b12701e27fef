"""Split-file writer (a copy of
``unsupervised_pose_estimation_tpu/data/make_splits.py``; the same files
for the same tree and seed).

The original repository exposes ``--write_split_file`` but never implements
it; its split files are checked-in artifacts. This module generates them:
scan a dataset tree, enumerate frames per sequence folder, hold out boundary
frames for the temporal window, and write
``{train,val}_files[_phantom].txt`` lines "folder frame_id side" in the
original format.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

_FRAME_RE = re.compile(r"^(\d+)\.(png|jpg|jpeg)$")


def scan_sequences(data_path: str) -> List[Tuple[str, List[int]]]:
    """-> [(folder, sorted frame indices)] for lung-layout trees
    (<data_path>/<folder>/<frame:010d>.png)."""
    sequences = []
    for folder in sorted(os.listdir(data_path)):
        full = os.path.join(data_path, folder)
        if not os.path.isdir(full):
            continue
        frames = []
        for name in os.listdir(full):
            m = _FRAME_RE.match(name)
            if m:
                frames.append(int(m.group(1)))
        if frames:
            sequences.append((folder, sorted(frames)))
    return sequences


def write_split(data_path: str, out_dir: str, val_fraction: float = 0.1,
                side: str = "l", margin: int = 1, suffix: str = "_phantom",
                seed: int = 0) -> Tuple[str, str]:
    """Write train/val split files; returns their paths.

    ``margin`` frames are dropped at each sequence boundary so every listed
    frame has neighbours at the maximum sampling stride.
    """
    lines = []
    for folder, frames in scan_sequences(data_path):
        usable = frames[margin:len(frames) - margin] if margin else frames
        lines.extend(f"{folder} {idx} {side}" for idx in usable)
    if not lines:
        raise FileNotFoundError(f"no frames found under {data_path}")

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(lines))
    n_val = max(1, int(len(lines) * val_fraction))
    val_idx = set(order[:n_val].tolist())

    os.makedirs(out_dir, exist_ok=True)
    train_path = os.path.join(out_dir, f"train_files{suffix}.txt")
    val_path = os.path.join(out_dir, f"val_files{suffix}.txt")
    with open(train_path, "w") as tf, open(val_path, "w") as vf:
        for i, line in enumerate(lines):
            (vf if i in val_idx else tf).write(line + "\n")
    return train_path, val_path
