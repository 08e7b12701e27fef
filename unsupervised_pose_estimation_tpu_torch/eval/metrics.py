"""Evaluation metrics: the depth error suite, flip post-processing, and
odometry ATE and rotation error.

A copy of ``unsupervised_pose_estimation_tpu/eval/metrics.py`` (numpy
only), with the formulas of the original monodepth2 fork:
``evaluate_depth.py:27-45`` (depth errors), ``:48-56`` (flip merge) and
``evaluate_pose.py:40-69`` (ATE over 5-frame tracks, rotation error).
"""

from __future__ import annotations

import numpy as np


def compute_depth_errors(gt: np.ndarray, pred: np.ndarray):
    """-> (abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3)."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()

    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = (np.abs(gt - pred) / gt).mean()
    sq_rel = (((gt - pred) ** 2) / gt).mean()
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def resize_bilinear_np(img: np.ndarray, out_h: int, out_w: int):
    """Half-pixel bilinear resize (cv2.resize / F.interpolate
    align_corners=False semantics, used at reference evaluate_depth.py:184
    and trainer.py:694-695)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


# metric keys of the reference's train-time GT monitoring
# (the original repository's trainer.py:261-262)
TRAIN_DEPTH_METRIC_NAMES = ("de/abs_rel", "de/sq_rel", "de/rms",
                            "de/log_rms", "da/a1", "da/a2", "da/a3")


def train_time_depth_metrics(pred_depth: np.ndarray, depth_gt: np.ndarray):
    """Batch-averaged GT depth metrics for monitoring during training —
    the `compute_depth_losses` analogue (the original repository's `trainer.py:688-716`;
    its own docstring flags the whole-batch averaging as approximate).

    pred_depth: (B, h, w) predicted depth; depth_gt: (B, H, W) with zeros
    where GT is absent. Predictions are bilinearly resized to the GT
    resolution, clamped to [1e-3, 80], masked by gt>0 AND the garg/eigen crop
    (rows 153:371, cols 44:1197 — applied verbatim as the reference does,
    regardless of dataset). GT smaller than the crop origin (endovis 192x192,
    synthetic benches) would always yield an empty mask under the verbatim
    crop, so when cropping empties the mask we fall back to the uncropped
    gt>0 mask instead of dropping the monitor. Then median-scaled. Returns
    {} only when gt>0 is empty everywhere."""
    b, gt_h, gt_w = depth_gt.shape
    pred = np.stack([resize_bilinear_np(p, gt_h, gt_w) for p in pred_depth])
    pred = np.clip(pred, 1e-3, 80.0)

    valid = depth_gt > 0
    crop = np.zeros_like(valid)
    crop[:, 153:371, 44:1197] = True
    mask = valid & crop
    if not mask.any():
        mask = valid
    if not mask.any():
        return {}
    gt = depth_gt[mask]
    pred = pred[mask]
    pred = pred * (np.median(gt) / np.median(pred))
    pred = np.clip(pred, 1e-3, 80.0)
    return dict(zip(TRAIN_DEPTH_METRIC_NAMES,
                    (float(v) for v in compute_depth_errors(gt, pred))))


def batch_post_process_disparity(l_disp: np.ndarray, r_disp: np.ndarray):
    """Merge left/flipped disparities with the monodepth ramp mask."""
    _, h, w = l_disp.shape
    m_disp = 0.5 * (l_disp + r_disp)
    grid_l, _ = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h),
                            indexing="xy")
    l_mask = 1.0 - np.clip(20 * (grid_l - 0.05), 0, 1)[None, ...]
    r_mask = l_mask[:, :, ::-1]
    return r_mask * l_disp + l_mask * r_disp + \
        (1.0 - l_mask - r_mask) * m_disp


# ---------------------------------------------------------------------------
# pose / odometry
# ---------------------------------------------------------------------------


def dump_xyz(source_to_target_transformations):
    """Chain local SE(3)s into global translations
    (`evaluate_pose.py:17-26`)."""
    xyzs = []
    cam_to_world = np.eye(4)
    xyzs.append(cam_to_world[:3, 3])
    for t in source_to_target_transformations:
        cam_to_world = np.dot(cam_to_world, t)
        xyzs.append(cam_to_world[:3, 3])
    return xyzs


def dump_r(source_to_target_transformations):
    """Chain local SE(3)s into global rotations (`evaluate_pose.py:28-36`)."""
    rs = []
    cam_to_world = np.eye(4)
    rs.append(cam_to_world[:3, :3])
    for t in source_to_target_transformations:
        cam_to_world = np.dot(cam_to_world, t)
        rs.append(cam_to_world[:3, :3])
    return rs


def compute_ate(gtruth_xyz, pred_xyz_o):
    """Absolute trajectory RMSE after offset + lstsq scale alignment
    (`evaluate_pose.py:40-52`)."""
    offset = gtruth_xyz[0] - pred_xyz_o[0]
    pred_xyz = pred_xyz_o + offset[None, :]

    scale = np.sum(gtruth_xyz * pred_xyz) / max(np.sum(pred_xyz ** 2), 1e-12)
    alignment_error = pred_xyz * scale - gtruth_xyz
    rmse = np.sqrt(np.sum(alignment_error ** 2)) / gtruth_xyz.shape[0]
    return rmse


def compute_re(gtruth_r, pred_r):
    """Mean geodesic rotation error (`evaluate_pose.py:55-69`)."""
    re = 0
    for gt_pose, pred_pose in zip(gtruth_r, pred_r):
        r = np.dot(gt_pose, np.linalg.inv(pred_pose))
        cos_angle = (np.trace(r) - 1.0) / 2.0
        re += np.arccos(np.clip(cos_angle, -1.0, 1.0))
    return re / max(len(gtruth_r), 1)
