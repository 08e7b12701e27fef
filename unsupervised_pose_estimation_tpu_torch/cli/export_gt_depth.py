"""Export ground-truth depth for a KITTI eval split to ``gt_depths.npz``:

    python -m unsupervised_pose_estimation_tpu_torch.cli.export_gt_depth \
        --data_path <kitti> --split eigen|eigen_benchmark [--split_dir DIR]

Port of ``unsupervised_pose_estimation_tpu/cli/export_gt_depth.py`` (the
same npz, so ``evaluate_depth`` reads either tool's output): the eigen
split projects raw velodyne scans (velodyne-x as depth), eigen_benchmark
reads the annotated uint16 png / 256 maps with ``data.png``. The output is
an object array because KITTI GT frames have per-drive resolutions.
``main(argv)`` decodes through the native host routines (the route of a
CUDA device); ``main(argv, device="cpu")`` through numpy.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.png import read_png
from ..data.split import parse_split_line, readlines
from ..eval.kitti_depth import generate_depth_map
from ..ops.kernels._lib import native_route


def _gt_for_line(split: str, data_path: str, line: str,
                 native: bool) -> np.ndarray:
    folder, frame_index, _ = parse_split_line(line)
    if split == "eigen":
        drive_day = folder.split("/")[0]
        scan = os.path.join(data_path, folder, "velodyne_points", "data",
                            f"{frame_index:010d}.bin")
        return generate_depth_map(os.path.join(data_path, drive_day), scan,
                                  cam=2, vel_depth=True)
    if split == "eigen_benchmark":
        png = os.path.join(data_path, folder, "proj_depth", "groundtruth",
                           "image_02", f"{frame_index:010d}.png")
        depth = read_png(png, native)
        if depth.dtype != np.uint16 or depth.ndim != 2:
            raise ValueError(f"{png}: {depth.shape} {depth.dtype}, "
                             "expected 16-bit grey")
        return depth.astype(np.float32) / 256.0
    raise ValueError(f"no GT recipe for split '{split}' "
                     "(expected eigen or eigen_benchmark)")


def export_gt_depths_kitti(opt, device="cuda") -> str:
    """Write <splits>/<split>/gt_depths.npz; returns the output path."""
    split_dir = getattr(opt, "split_dir", None) or os.path.join(
        os.path.dirname(__file__), "..", "..", "splits")
    split_folder = os.path.join(split_dir, opt.split)
    lines = readlines(os.path.join(split_folder, "test_files.txt"))

    print(f"-> Exporting {len(lines)} GT depth maps for the "
          f"'{opt.split}' split")
    native = native_route(device)
    maps = [_gt_for_line(opt.split, opt.data_path, line,
                         native).astype(np.float32) for line in lines]

    out_path = os.path.join(split_folder, "gt_depths.npz")
    np.savez_compressed(out_path, data=np.array(maps, dtype="object"))
    print(f"-> Wrote {out_path}")
    return out_path


def main(argv=None, device="cuda"):
    """-> the npz's path."""
    parser = argparse.ArgumentParser(description="export_gt_depth")
    parser.add_argument("--data_path", required=True,
                        help="root of the KITTI data tree")
    parser.add_argument("--split", required=True,
                        choices=["eigen", "eigen_benchmark"])
    parser.add_argument("--split_dir", default=None,
                        help="override the repo splits/ root")
    return export_gt_depths_kitti(parser.parse_args(argv), device)


if __name__ == "__main__":
    main()
