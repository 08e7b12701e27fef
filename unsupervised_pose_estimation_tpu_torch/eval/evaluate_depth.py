"""Depth evaluation driver.

Port of ``unsupervised_pose_estimation_tpu/eval/evaluate_depth.py``: load a
checkpoint, run batched inference over the eval split (with the
flip-ensemble post-process on request), resize the predictions to the
ground truth, crop KITTI's eigen split, scale by the median (mono) or by
the stereo factor, clamp to [1e-3, 80] and print the 7-metric row. It runs
on the CUDA device unless the caller passes ``device="cpu"``.

``dataset`` ``synthetic`` and ``synthetic_parallax`` are read through a
split too: the split file's line count is the number of items, and item i
is the dataset's validation item i (``seed`` 0), so a split directory with
its ``gt_depths.npz`` evaluates with no image file at all.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..config import Options
from ..data.datasets import make_dataset
from ..data.png import write_png
from ..data.pipeline import Loader
from ..data.split import readlines, resolve_split_file
from ..ops.geometry import disp_to_depth
from ..ops.kernels._lib import native_route
from ..train.bundle import ModelBundle
from ..train.checkpoint import (import_depth_decoder, latest_step,
                                load_pth_folder, restore_checkpoint)
from ..train.loop import resolve_device
from ..train.step import build_infer_step
from .metrics import (batch_post_process_disparity, compute_depth_errors,
                      resize_bilinear_np)

# "stereo" training produces scale-aware depth: nominal 0.1 baseline vs the
# 54 cm KITTI rig (the original repository's evaluate_depth.py:21-24)
STEREO_SCALE_FACTOR = 5.4

MIN_DEPTH_EVAL = 1e-3
MAX_DEPTH_EVAL = 80.0

SYNTHETIC = ("synthetic", "synthetic_parallax")


class _EvalFrames:
    """Single-frame eval items (frame_ids=[0]) from any dataset class."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def get_item(self, index, epoch=0):
        item = self.dataset.get_item(index, epoch)
        color = item["color"][0]
        if color.dtype == np.uint8:
            color = color.astype(np.float32) / 255.0
        return {"color": color}  # (H, W, 3) float32 [0,1]


def splits_root(opt: Options) -> str:
    """--split_dir override, else the repo's vendored splits/ tree."""
    return opt.split_dir or os.path.join(os.path.dirname(__file__),
                                         "..", "..", "splits")


def eval_dataset(opt: Options, filenames, frame_idxs, native=False):
    """The validation dataset of ``opt.dataset`` over ``filenames``; for the
    synthetic datasets, one item per line. ``native``: the file datasets
    decode and resize through the native host routines."""
    extra = {}
    if opt.dataset in SYNTHETIC:
        extra = {"num_items": len(filenames),
                 "with_rotation": opt.synthetic_rotation}
    return make_dataset(opt.dataset, data_path=opt.data_path,
                        filenames=filenames, height=opt.height,
                        width=opt.width, frame_idxs=frame_idxs,
                        is_train=False, img_ext=".png", native=native,
                        **extra)


def write_synthetic_split(opt: Options, num_items: int) -> str:
    """Write the eval split ``opt.eval_split`` under ``splits_root(opt)`` for
    ``num_items`` synthetic_parallax items as ``eval_dataset`` reads them:
    ``test_files.txt`` (one line per item), ``gt_depths.npz`` (the exact
    depth of each item's frame 0) and ``gt_poses_sq2.npz`` (its exact
    frame 0 -> frame 1 pose); -> the split's directory."""
    from ..data.datasets import SyntheticParallaxDataset

    out = os.path.join(splits_root(opt), opt.eval_split)
    os.makedirs(out, exist_ok=True)
    ds = SyntheticParallaxDataset(num_items, opt.height, opt.width, [0],
                                  is_train=False, load_depth=True,
                                  with_rotation=opt.synthetic_rotation)
    with open(os.path.join(out, "test_files.txt"), "w") as f:
        f.write("".join(f"synthetic {i} l\n" for i in range(num_items)))
    np.savez(os.path.join(out, "gt_depths.npz"), data=np.stack(
        [ds.get_item(i)["depth_gt"] for i in range(num_items)]))
    np.savez(os.path.join(out, "gt_poses_sq2.npz"), data=np.stack(
        [ds.gt_pose(i, 1) for i in range(num_items)]))
    return out


def load_eval_state(opt: Options, device="cuda",
                    models_to_load=("encoder", "depth")) -> ModelBundle:
    """The bundle of ``opt`` (at ``opt.compute_dtype``) with the weights of
    ``opt.load_weights_folder``: a checkpoint directory of this package (its
    latest step; parameters are float32 whatever dtype wrote it) or a
    folder of reference ``.pth`` files, of which ``models_to_load`` must
    all be there. When a ``.pth`` depth decoder is of another variant than
    ``opt.depth_decoder_variant`` (upstream monodepth2 or the fork's
    deconv + BatchNorm), the bundle is built with the detected variant, as
    the reference's ``load_eval_state`` does, so that no layer runs with
    random weights."""
    folder = os.path.expanduser(opt.load_weights_folder or "")
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"Cannot find folder {folder}")
    pth = latest_step(folder) is None
    depth_file = os.path.join(folder, "depth.pth")
    depth_tree = None
    if pth and "depth" in models_to_load and os.path.isfile(depth_file):
        depth_tree = import_depth_decoder(depth_file)
        variant = depth_tree["variant"]
        if variant != opt.depth_decoder_variant:
            print(f"-> depth.pth detected as '{variant}' decoder; building "
                  f"that variant")
            opt = dataclasses.replace(opt, depth_decoder_variant=variant)
    bundle = ModelBundle.create(opt, seed=opt.seed,
                                device=resolve_device(device))
    if pth:
        load_pth_folder(bundle, folder, models_to_load, skip_missing=False,
                        depth_tree=depth_tree)
    else:
        restore_checkpoint(folder, bundle)
    return bundle.eval()


def predict_disparities(opt: Options, bundle: ModelBundle,
                        filenames) -> np.ndarray:
    """-> (N, H, W) scaled disparities of frame 0 of each line, in order."""
    device = next(bundle.parameters()).device
    ds = eval_dataset(opt, filenames, [0], native_route(device))
    frames = _EvalFrames(ds)
    infer = build_infer_step(bundle)

    def scaled(img):
        out = infer(img)[0][..., 0].cpu().numpy()
        return disp_to_depth(out, opt.min_depth, opt.max_depth)[0]

    batches = Loader(frames, min(opt.batch_size, len(ds)), shuffle=False,
                     device=device, num_workers=8, prefetch=2).epoch(0)
    disps = []
    try:
        for batch in batches:
            img = batch["color"]
            if not opt.post_process:
                disps.append(scaled(img))
                continue
            both = scaled(torch.cat([img, img.flip(2)], 0))
            n = both.shape[0] // 2
            disps.append(batch_post_process_disparity(both[:n],
                                                      both[n:, :, ::-1]))
    finally:
        batches.close()  # ends the loader's threads if a step raised
    # drop_last trims the tail; evaluate the remaining frames one by one
    n_done = sum(d.shape[0] for d in disps)
    for i in range(n_done, len(ds)):
        img = torch.from_numpy(frames.get_item(i)["color"][None])
        disps.append(scaled(img.to(device)))
    return np.concatenate(disps, 0)


def _save_benchmark_pngs(pred_disps: np.ndarray, save_dir: str):
    """KITTI online-benchmark submission: uint16 depth * 256 at 1216x352,
    16-bit grey PNGs (``data.png.write_png``)."""
    os.makedirs(save_dir, exist_ok=True)
    for idx in range(len(pred_disps)):
        disp_resized = resize_bilinear_np(pred_disps[idx], 352, 1216)
        depth = STEREO_SCALE_FACTOR / np.maximum(disp_resized, 1e-9)
        depth = np.clip(depth, 0, 80)
        depth16 = (depth * 256).astype(np.uint16)
        write_png(os.path.join(save_dir, f"{idx:010d}.png"), depth16)


def evaluate(opt: Options, gt_depths: Optional[np.ndarray] = None,
             device="cuda"):
    """Returns the metric row dict and prints it reference-style."""
    if opt.eval_mono and opt.eval_stereo:
        raise ValueError("Please choose mono or stereo evaluation by "
                         "selecting either --eval_mono or --eval_stereo")

    splits_dir = splits_root(opt)

    if opt.ext_disp_to_eval is None:
        files = readlines(resolve_split_file(splits_dir, opt.eval_split))
        bundle = load_eval_state(opt, device)
        pred_disps = predict_disparities(opt, bundle, files)
    else:
        print(f"-> Loading predictions from {opt.ext_disp_to_eval}")
        pred_disps = np.load(opt.ext_disp_to_eval)
        if opt.eval_eigen_to_benchmark:
            # remap eigen-ordered results onto the benchmark split
            ids = np.load(os.path.join(splits_dir, "benchmark",
                                       "eigen_to_benchmark_ids.npy"))
            pred_disps = pred_disps[ids]

    if opt.save_pred_disps:
        out = os.path.join(opt.load_weights_folder or ".",
                           f"disps_{opt.eval_split}_split.npy")
        print("-> Saving predicted disparities to ", out)
        np.save(out, pred_disps)

    if opt.no_eval:
        print("-> Evaluation disabled. Done.")
        return None

    if opt.eval_split == "benchmark":
        save_dir = os.path.join(opt.load_weights_folder or ".",
                                "benchmark_predictions")
        print(f"-> Saving out benchmark predictions to {save_dir}")
        _save_benchmark_pngs(pred_disps, save_dir)
        print("-> No ground truth is available for the KITTI benchmark, "
              "so not evaluating. Done.")
        return None

    if gt_depths is None:
        gt_path = os.path.join(splits_dir, opt.eval_split, "gt_depths.npz")
        gt_depths = np.load(gt_path, fix_imports=True,
                            allow_pickle=True)["data"]

    print("-> Evaluating")
    if opt.eval_stereo:
        print("   Stereo evaluation - disabling median scaling, "
              f"scaling by {STEREO_SCALE_FACTOR}")
        opt = dataclasses.replace(opt, disable_median_scaling=True,
                                  pred_depth_scale_factor=STEREO_SCALE_FACTOR)
    else:
        print("   Mono evaluation - using median scaling")

    errors = []
    ratios = []
    for i in range(min(pred_disps.shape[0], len(gt_depths))):
        gt_depth = gt_depths[i]
        gt_height, gt_width = gt_depth.shape[:2]
        pred_disp = resize_bilinear_np(pred_disps[i], gt_height, gt_width)
        pred_depth = 1.0 / np.maximum(pred_disp, 1e-12)

        if opt.eval_split == "eigen":
            mask = np.logical_and(gt_depth > MIN_DEPTH_EVAL,
                                  gt_depth < MAX_DEPTH_EVAL)
            crop = np.array([0.40810811 * gt_height, 0.99189189 * gt_height,
                             0.03594771 * gt_width, 0.96405229 * gt_width]
                            ).astype(np.int32)
            crop_mask = np.zeros(mask.shape)
            crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
            mask = np.logical_and(mask, crop_mask)
        else:
            mask = gt_depth > 0

        pred_depth = pred_depth[mask]
        gt_depth = gt_depth[mask]
        if gt_depth.size == 0:
            continue

        pred_depth *= opt.pred_depth_scale_factor
        if not opt.disable_median_scaling:
            ratio = np.median(gt_depth) / np.median(pred_depth)
            ratios.append(ratio)
            pred_depth *= ratio

        pred_depth = np.clip(pred_depth, MIN_DEPTH_EVAL, MAX_DEPTH_EVAL)
        errors.append(compute_depth_errors(gt_depth, pred_depth))

    if not opt.disable_median_scaling and ratios:
        ratios = np.array(ratios)
        med = np.median(ratios)
        print(f" Scaling ratios | med: {med:0.3f} | "
              f"std: {np.std(ratios / med):0.3f}")

    mean_errors = np.array(errors).mean(0)
    names = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
    print("\n  " + ("{:>8} | " * 7).format(*names))
    print(("&{: 8.3f}  " * 7).format(*mean_errors.tolist()) + "\\\\")
    print("\n-> Done!")
    return dict(zip(names, mean_errors.tolist()))
