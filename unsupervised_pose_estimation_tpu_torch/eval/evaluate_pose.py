"""Pose / odometry evaluation driver.

Port of ``unsupervised_pose_estimation_tpu/eval/evaluate_pose.py``: run the
pose network over consecutive frame pairs of the eval split, chain the
local SE(3)s, score ATE and rotation error over 5-frame tracks against
ground-truth poses, and optionally plot the scale-aligned trajectory to
``vo.png``. It runs on the CUDA device unless the caller passes
``device="cpu"``. Unlike the reference package, whose ``load_eval_state``
reads only the depth files of a ``.pth`` folder, the pose files
(``pose_encoder.pth``, ``pose.pth``) are the ones loaded.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import Options
from ..data.split import readlines, resolve_split_file
from ..ops.geometry import transformation_from_parameters
from ..ops.kernels._lib import native_route
from ..train.bundle import ModelBundle
from .evaluate_depth import eval_dataset, load_eval_state, splits_root
from .metrics import compute_ate, compute_re, dump_r, dump_xyz

TRACK_LENGTH = 5


def predict_pose_sequence(opt: Options, bundle: ModelBundle,
                          filenames) -> np.ndarray:
    """-> (N, 4, 4) local source->target transforms of frames (0, 1) of each
    line, as the reference feeds them: [frame 1, frame 0] on the channels,
    in batches of ``opt.batch_size`` pairs (the last one shorter). Only a
    separate ResNet pose network over pairs is evaluated, as in the
    reference package."""
    cfg = bundle.cfg
    if cfg.pose_model_type != "separate_resnet" or cfg.num_pose_frames != 2:
        raise ValueError(f"pose evaluation runs a separate_resnet pose "
                         f"network over pairs; this one is "
                         f"{cfg.pose_model_type} over "
                         f"{cfg.pose_model_input}")
    device = next(bundle.parameters()).device
    ds = eval_dataset(opt, filenames, [0, 1], native_route(device))
    bundle.eval()

    def pose(pairs):
        x = torch.from_numpy(np.stack(pairs, 0)).to(device)
        with torch.inference_mode():
            feats = bundle.pose_encoder(x.permute(0, 3, 1, 2).contiguous())
            aa, tt = bundle.pose([feats])
            out = transformation_from_parameters(aa[:, 0, 0], tt[:, 0, 0])
        return out.cpu().numpy()

    preds = []
    bs = max(1, opt.batch_size)
    buf = []
    for i in range(len(ds)):
        item = ds.get_item(i)
        color = item["color"].astype(np.float32)
        if item["color"].dtype == np.uint8:
            color = color / 255.0
        buf.append(np.concatenate([color[1], color[0]], axis=-1))
        if len(buf) == bs or i == len(ds) - 1:
            preds.append(pose(buf))
            buf = []
    return np.concatenate(preds, 0)


# matplotlib's defaults for ``fig.add_subplot(projection="3d")`` saved at
# dpi=150: a 6.4 x 4.8 inch figure, the subplot's box, the 3D view
# (elev 30, azim -60, perspective at focal length 1 from a distance of 10,
# box aspect 4:4:3), the 2D view limits its ``set_top_view`` gives, the
# autoscale margins, line width 1.5 pt and the colours C0 and C1.
PLOT_W, PLOT_H = 960, 720
_SUBPLOT = (0.125, 0.11, 0.775, 0.77)
_ELEV, _AZIM, _DIST = 30.0, -60.0, 10.0
_MARGINS, _VIEW_MARGIN = (0.05, 0.05, 0.0), 1 / 48
_LINE_PX = 1.5 * 150 / 72
COLORS = ((0x1F, 0x77, 0xB4), (0xFF, 0x7F, 0x0E))


def _limits(points: np.ndarray):
    """The axes' 3D limits over ``points`` (N, 3), as matplotlib
    autoscales them: the data's range (a flat one widened by 5%), a margin
    of 5% on x and y (none on z), then 1/48 more each side."""
    lims = []
    for lo, hi, margin in zip(points.min(0), points.max(0), _MARGINS):
        lo, hi = float(lo), float(hi)
        if hi - lo <= max(abs(lo), abs(hi)) * 1e-15:
            lo, hi = ((-0.05, 0.05) if lo == hi == 0
                      else (lo - 0.05 * abs(lo), hi + 0.05 * abs(hi)))
        for m in (margin, _VIEW_MARGIN):
            d = (hi - lo) * m
            lo, hi = lo - d, hi + d
        lims.append((lo, hi))
    return lims


def project(points: np.ndarray, lims) -> np.ndarray:
    """(N, 3) data points -> (N, 2) pixel coordinates (column, row) on the
    PLOT_W x PLOT_H canvas through matplotlib's default 3D view."""
    aspect = np.array([4.0, 4.0, 3.0])
    aspect *= 1.8294640721620434 * 25 / 24 / np.linalg.norm(aspect)
    world = np.eye(4)
    for k, (lo, hi) in enumerate(lims):
        d = (hi - lo) / aspect[k]
        world[k, k], world[k, 3] = 1 / d, -lo / d
    elev, azim = np.deg2rad(_ELEV), np.deg2rad(_AZIM)
    ps = np.array([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim),
                   np.sin(elev)])
    centre = 0.5 * aspect
    eye = centre + _DIST * ps
    w = (eye - centre) / np.linalg.norm(eye - centre)
    u = np.cross([0.0, 0.0, 1.0], w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    view = np.eye(4)
    view[:3, :3] = [u, v, w]
    shift = np.eye(4)
    shift[:3, 3] = -eye
    b = (-_DIST + _DIST) / (-2 * _DIST)
    c = -2 * (-_DIST * _DIST) / (-2 * _DIST)
    persp = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, b, c],
                      [0, 0, -1, 0]])
    m = persp @ view @ shift @ world
    hom = m @ np.c_[points, np.ones(len(points))].T
    xy = hom[:2] / hom[3]
    # the 2D view limits (-0.95, 0.9) / dist on both axes, in the subplot
    # box made square and centred
    x0, y0, bw, bh = (_SUBPLOT[0] * PLOT_W, _SUBPLOT[1] * PLOT_H,
                      _SUBPLOT[2] * PLOT_W, _SUBPLOT[3] * PLOT_H)
    side = min(bw, bh)
    x0, y0 = x0 + (bw - side) / 2, y0 + (bh - side) / 2
    lo, span = -0.95 / _DIST, 1.85 / _DIST
    col = x0 + (xy[0] - lo) / span * side
    row = PLOT_H - (y0 + (xy[1] - lo) / span * side)
    return np.stack([col, row], -1)


def _draw_polyline(canvas: np.ndarray, pts: np.ndarray, color) -> None:
    """Stamp a disc of the line's width at points along each segment of
    ``pts`` (N, 2) (column, row) on ``canvas`` (H, W, 3), no
    anti-aliasing."""
    r = _LINE_PX / 2
    steps = [np.linspace(0, 1, max(2, int(np.hypot(*(b - a)) * 2) + 2))
             for a, b in zip(pts[:-1], pts[1:])]
    dense = np.concatenate([pts[:1]] + [
        a + (b - a) * t[:, None] for a, b, t in zip(pts[:-1], pts[1:],
                                                     steps)])
    k = int(np.ceil(r))
    dy, dx = np.mgrid[-k:k + 1, -k:k + 1]
    for off_r, off_c in zip(*np.nonzero(dx ** 2 + dy ** 2 <= r * r)):
        rows = np.floor(dense[:, 1]).astype(np.int64) + off_r - k
        cols = np.floor(dense[:, 0]).astype(np.int64) + off_c - k
        inside = (rows >= 0) & (rows < canvas.shape[0]) & (cols >= 0) & \
            (cols < canvas.shape[1])
        canvas[rows[inside], cols[inside]] = color


def trajectory_points(gt_xyz: np.ndarray, pred_xyz: np.ndarray):
    """The two point sets the plot draws: the ground truth, and the
    prediction scaled by the least-squares factor onto it (float64)."""
    scale = np.sum(gt_xyz * pred_xyz) / max(np.sum(pred_xyz ** 2), 1e-12)
    return [np.asarray(gt_xyz, np.float64),
            np.asarray(pred_xyz * scale, np.float64)]


def plot_trajectory(gt_xyz: np.ndarray, pred_xyz: np.ndarray,
                    out_path: str = "vo.png"):
    """The scale-aligned 3D trajectories (``trajectory_points``), written to
    ``out_path`` as a PNG without matplotlib.

    The points are those the reference package's matplotlib plot draws, and
    they are projected through matplotlib's default 3D view of them (elev
    30, azim -60, perspective, box aspect 4:4:3, its autoscaled limits) onto
    the 960x720 canvas of a default figure saved at dpi=150. The picture
    differs from matplotlib's: only the two polylines are drawn, in C0 and
    C1, 1.5 pt wide, without anti-aliasing, on white; there are no panes,
    grid, axes, ticks, labels or legend. -> the (N, 2) pixel coordinates of
    each set, ground truth first."""
    from ..data.png import write_png

    sets = trajectory_points(gt_xyz, pred_xyz)
    lims = _limits(np.concatenate(sets))
    canvas = np.full((PLOT_H, PLOT_W, 3), 255, np.uint8)
    pixels = []
    for pts, color in zip(sets, COLORS):
        px = project(pts, lims)
        _draw_polyline(canvas, px, color)
        pixels.append(px)
    write_png(out_path, canvas)
    return pixels


def evaluate(opt: Options, gt_poses: Optional[np.ndarray] = None,
             device="cuda"):
    """Score ATE/RE. ``gt_poses``: (N, 4, 4) LOCAL source->target transforms
    (overrides the split's gt_poses_sq2.npz)."""
    splits_dir = splits_root(opt)
    filenames = readlines(resolve_split_file(splits_dir, opt.eval_split))

    bundle = load_eval_state(opt, device,
                             models_to_load=("pose_encoder", "pose"))
    pred_local = predict_pose_sequence(opt, bundle, filenames)

    if gt_poses is None:
        gt_path = os.path.join(splits_dir, opt.eval_split,
                               "gt_poses_sq2.npz")
        gt_poses = np.load(gt_path, allow_pickle=True)["data"]
    # The npz stores LOCAL source->target transforms, consumed directly, as
    # the original repository's evaluate_pose.py:201-213 does
    gt_local = np.asarray(gt_poses)

    n = min(len(pred_local), len(gt_local))
    ates, res = [], []
    for i in range(0, n - TRACK_LENGTH + 1):
        local_xyzs = np.array(dump_xyz(pred_local[i:i + TRACK_LENGTH - 1]))
        gt_xyzs = np.array(dump_xyz(gt_local[i:i + TRACK_LENGTH - 1]))
        local_rs = np.array(dump_r(pred_local[i:i + TRACK_LENGTH - 1]))
        gt_rs = np.array(dump_r(gt_local[i:i + TRACK_LENGTH - 1]))
        ates.append(compute_ate(gt_xyzs, local_xyzs))
        res.append(compute_re(gt_rs, local_rs))

    print(f"\n   Trajectory error: {np.mean(ates):0.4f}, "
          f"std: {np.std(ates):0.4f}\n")
    print(f"\n   Rotation error: {np.mean(res):0.4f}, "
          f"std: {np.std(res):0.4f}\n")

    if opt.eval_pose_trajectory:
        pred_xyz = np.array(dump_xyz(pred_local[:n]))
        gt_xyz = np.array(dump_xyz(gt_local[:n]))
        plot_trajectory(gt_xyz, pred_xyz,
                        os.path.join(opt.eval_out_dir or ".", "vo.png"))

    return {"ate_mean": float(np.mean(ates)), "ate_std": float(np.std(ates)),
            "re_mean": float(np.mean(res)), "re_std": float(np.std(res))}
