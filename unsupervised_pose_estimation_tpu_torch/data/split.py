"""Split-file parsing (a copy of
``unsupervised_pose_estimation_tpu/data/split.py``).

Split files are text lines "folder [frame_id] [side]", as in the repo's
``splits/`` directory.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple


def readlines(filename: str) -> List[str]:
    with open(filename, "r") as f:
        return f.read().splitlines()


def resolve_split_file(splits_dir: str, split: str, mode: str = "test") -> str:
    """-> the split list file for (split, mode), trying the layouts the
    reference uses: plain ``<mode>_files.txt``, the endovis
    ``<mode>_files_phantom.txt`` pattern (the original repository's `trainer.py:204`),
    and the upstream odometry aliases ``odom_9``/``odom_10`` ->
    ``odom/<mode>_files_09.txt``."""
    candidates = []
    if split.startswith("odom_"):
        seq = int(split.split("_")[1])
        candidates.append(os.path.join(splits_dir, "odom",
                                       f"{mode}_files_{seq:02d}.txt"))
    candidates += [
        os.path.join(splits_dir, split, f"{mode}_files.txt"),
        os.path.join(splits_dir, split, f"{mode}_files_phantom.txt"),
    ]
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(
        f"no {mode} split list for '{split}' (tried {candidates})")


def parse_split_line(line: str) -> Tuple[str, int, Optional[str]]:
    """-> (folder, frame_index, side); missing fields default to (0, None)."""
    parts = line.split()
    folder = parts[0]
    frame_index = int(parts[1]) if len(parts) >= 2 else 0
    side = parts[2] if len(parts) >= 3 else None
    return folder, frame_index, side
