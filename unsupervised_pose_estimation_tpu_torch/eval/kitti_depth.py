"""KITTI velodyne -> sparse depth map (host-side numpy).

A copy of ``unsupervised_pose_estimation_tpu/eval/kitti_depth.py``: the
community-standard projection of the original repository's
``generate_depth_map`` (``kitti_utils.py:46-98``). Two quirks are kept for
bit-parity: pixel indices are ``round(u) - 1`` / ``round(v) - 1``, and the
duplicate-bucket key is ``v*(W-1) + u - 1`` (not a raveled index), so the
nearest depth of a shared bucket lands on the first point's pixel. The
dedup is vectorized (``np.unique`` + ``np.minimum.at``).
"""

from __future__ import annotations

import os

import numpy as np


def load_velodyne_points(path: str) -> np.ndarray:
    """(N, 4) float32 scan; reflectance column replaced by 1 (homogeneous)."""
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    scan[:, 3] = 1.0
    return scan


def read_calib_file(path: str) -> dict:
    """KITTI calib text -> {key: float ndarray | str}."""
    out: dict = {}
    for raw in open(path):
        if ":" in raw:
            key, _, rest = raw.partition(":")
        else:
            fields = raw.split()
            if not fields:
                continue
            key, rest = fields[0], " ".join(fields[1:])
        key = key.strip()
        try:
            out[key] = np.asarray(rest.split(), dtype=np.float64)
        except ValueError:
            out[key] = rest.strip()
    return out


def _velo_to_image_matrix(calib_dir: str, cam: int) -> tuple:
    """-> (3x4 projection velodyne->image plane of camera `cam`, (H, W))."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam = read_calib_file(os.path.join(calib_dir,
                                            "calib_velo_to_cam.txt"))
    extrinsic = np.eye(4)
    extrinsic[:3, :3] = velo2cam["R"].reshape(3, 3)
    extrinsic[:3, 3] = velo2cam["T"]
    rectify = np.eye(4)
    rectify[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    proj = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    h, w = cam2cam["S_rect_02"][::-1].astype(np.int32)
    return proj @ rectify @ extrinsic, (int(h), int(w))


def generate_depth_map(calib_dir: str, velo_filename: str, cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """-> (H, W) float depth map in meters, zero where the scan has no return.

    ``vel_depth=True`` stores the velodyne forward coordinate instead of the
    rectified-camera z (used by the eigen GT export).
    """
    P, (h, w) = _velo_to_image_matrix(calib_dir, cam)

    scan = load_velodyne_points(velo_filename)
    scan = scan[scan[:, 0] >= 0]  # keep the forward half-space

    cam_pts = scan @ P.T  # (N, 3): (u*z, v*z, z)
    z = scan[:, 0] if vel_depth else cam_pts[:, 2]
    # matlab-offset integer pixel coordinates (kitti_utils.py:74-76)
    u = np.round(cam_pts[:, 0] / cam_pts[:, 2]) - 1
    v = np.round(cam_pts[:, 1] / cam_pts[:, 2]) - 1

    inside = (u >= 0) & (v >= 0) & (u < w) & (v < h)
    u = u[inside].astype(np.int64)
    v = v[inside].astype(np.int64)
    z = z[inside].astype(np.float64)

    depth = np.zeros((h, w))
    depth[v, u] = z  # last return wins the scatter; buckets fixed below

    # nearest-return resolution per quirk-key bucket (see module docstring)
    bucket = v * (w - 1) + u - 1
    _, first, inverse, counts = np.unique(
        bucket, return_index=True, return_inverse=True, return_counts=True)
    nearest = np.full(counts.shape, np.inf)
    np.minimum.at(nearest, inverse, z)
    multi = counts > 1
    depth[v[first[multi]], u[first[multi]]] = nearest[multi]

    depth[depth < 0] = 0
    return depth
