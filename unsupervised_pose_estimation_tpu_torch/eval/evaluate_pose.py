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


def plot_trajectory(gt_xyz: np.ndarray, pred_xyz: np.ndarray,
                    out_path: str = "vo.png"):
    """Scale-aligned 3D trajectory plot."""
    try:
        import matplotlib
    except ImportError as err:
        raise ImportError(
            "the trajectory plot (eval_pose_trajectory) needs matplotlib, "
            "which is not installed; pass --eval_pose_trajectory to turn "
            "the plot off") from err

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scale = np.sum(gt_xyz * pred_xyz) / max(np.sum(pred_xyz ** 2), 1e-12)
    pred = pred_xyz * scale
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.plot(gt_xyz[:, 0], gt_xyz[:, 1], gt_xyz[:, 2], label="ground truth")
    ax.plot(pred[:, 0], pred[:, 1], pred[:, 2], label="predicted")
    ax.legend()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


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
