"""Build the pre-decoded uint8 frame cache for a (dataset, split, feed size):

    python -m unsupervised_pose_estimation_tpu_torch.cli.build_frame_cache \
        --dataset endovis --split endovis --data_path <frames> \
        --height 192 --width 640 --frame_cache <cache_dir>

Port of ``unsupervised_pose_estimation_tpu/cli/build_frame_cache.py``: every
frame the train and val splits can reach, decoded and resized to the feed
(``data.cache.build_frame_cache``), under ``<cache_dir>/{train,val}``, the
bytes the reference's tool writes. ``main(argv)`` decodes and resizes
through the native host routines built with the CUDA kernels (the route of
a CUDA device); ``main(argv, device="cpu")`` through numpy.
"""

from __future__ import annotations

import os

from ..config import parse_options
from ..data.cache import build_frame_cache
from ..data.datasets import make_dataset
from ..data.split import readlines, resolve_split_file
from ..ops.kernels._lib import native_route


def main(argv=None, device="cuda"):
    """Build the caches; -> {mode: build_frame_cache's stats}."""
    cfg = parse_options(argv, description=__doc__).validate()
    if not cfg.frame_cache:
        raise SystemExit("--frame_cache <dir> is required")
    split_root = cfg.split_dir or os.path.join(
        os.path.dirname(__file__), "..", "..", "splits")
    frame_ids = list(cfg.frame_ids) + (["s"] if cfg.use_stereo else [])
    stats = {}
    for mode in ("train", "val"):
        files = readlines(resolve_split_file(split_root, cfg.split, mode))
        sf = cfg.sampling_frequency
        ds = make_dataset(cfg.dataset, data_path=cfg.data_path,
                          filenames=files[sf:-sf], height=cfg.height,
                          width=cfg.width, frame_idxs=frame_ids,
                          is_train=(mode == "train"), img_ext=".png",
                          sampling_frequency=sf,
                          native=native_route(device))
        stats[mode] = build_frame_cache(
            ds, os.path.join(cfg.frame_cache, mode), log=print)
        print(f"{mode}: {stats[mode]['rows']} frames cached, "
              f"{stats[mode]['skipped']} missing")
    return stats


if __name__ == "__main__":
    main()
