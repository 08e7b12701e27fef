"""The validation step and the depth-inference step.

Port of ``unsupervised_pose_estimation_tpu/train/step.py``:
``forward_and_loss`` with ``train=False`` (the reference trainer's
``val()``), ``build_eval_step`` and ``build_infer_step``, for the
configurations ``train.bundle.check_supported`` admits. On a CUDA device
the photometric terms run in the port's kernels: the fused warp + loss
(K1) for every scale and source frame, the SSIM + L1 loss (K3) for the
identity (automask) terms, and, when the warped images are returned, the
warp (K5) followed by K3. Training (gradients, device-side augmentation,
Adam) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops import geometry as G
from ..ops import losses as L
from ..ops.kernels import reproj_loss, warp, warp_reproj_loss
from ..ops.resize import image_pyramid, resize_bilinear
from .bundle import ModelBundle


def _f32(x):
    """uint8 [0, 255] -> float32 [0, 1]; float input as float32."""
    if x.dtype == torch.uint8:
        return x.float() * (1.0 / 255.0)
    return x.float()


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def predict_poses(bundle: ModelBundle, aug: Dict[int, torch.Tensor]):
    """cam_T_cam (B, 4, 4) for every temporal source frame: both pairs are
    stacked on the batch axis and go through the pose network in one
    forward, so BatchNorm sees them together (as in the reference)."""
    cfg = bundle.cfg
    sources = list(cfg.frame_ids[1:])
    b = aug[0].shape[0]
    pairs = [torch.cat([aug[f], aug[0]] if f < 0 else [aug[0], aug[f]], 1)
             for f in sources]
    feats = bundle.pose_encoder(torch.cat(pairs, 0))
    aa, tt = bundle.pose([feats])
    return {f: G.transformation_from_parameters(
        aa[k * b:(k + 1) * b, 0, 0], tt[k * b:(k + 1) * b, 0, 0],
        invert=(f < 0)) for k, f in enumerate(sources)}


def forward_and_loss(bundle: ModelBundle, batch, train: bool = False,
                     with_images: bool = False,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Dict[int, torch.Tensor]] = None):
    """Depth, pose, view synthesis and the monodepth2 loss for one batch.

    Args:
      batch: {'color': uint8 (B, F, H, W, 3), 'color_aug': uint8
        (B, F, H, W, 3), 'K_norm': (B, 4, 4)}, frames in ``frame_ids``
        order.
      with_images: also return the warped sources ('color_pred/f/s') and
        the automasks; the warp then runs unfused (K5 + K3).
      generator: draws the 1e-5 tie-break noise of the automask.
      noise: {scale: (B, H, W, S)} tie-break noise to use instead (tests
        pass the reference package's draw).

    Returns (total_loss, (losses, outputs)); outputs['disp'] maps each
    scale to its (B, h, w, 1) disparity.
    """
    if train:
        raise NotImplementedError("training is not ported yet")
    if "aug_params" in batch:
        raise NotImplementedError(
            "device-side augmentation (aug_params) is a training feature "
            "and is not ported yet")
    cfg = bundle.cfg
    h, w = cfg.height, cfg.width
    if batch["color"].dtype != torch.uint8:
        raise TypeError("batch['color'] must be uint8")
    frame_ids = list(cfg.frame_ids)
    sources = frame_ids[1:]
    f_index = {f: i for i, f in enumerate(frame_ids)}
    raw = {f: batch["color"][:, f_index[f]].contiguous() for f in frame_ids}
    color = {f: _f32(raw[f]) for f in frame_ids}
    aug = {f: _nchw(_f32(batch["color_aug"][:, f_index[f]]))
           for f in frame_ids}

    n_levels = max(cfg.scales) + 1
    pyr0 = image_pyramid(color[0], n_levels)
    K_norm = batch["K_norm"].float()
    Ks = G.scaled_intrinsics(K_norm, w, h, 0)
    inv_Ks = G.invert_intrinsics(Ks)

    features = bundle.encoder(aug[0])
    disps = {s: _nhwc(d) for s, d in bundle.depth(features).items()}
    poses = predict_poses(bundle, aug)

    def reproj_fn(pred_p, tgt_p):
        if cfg.no_ssim:
            return L.reprojection_loss_planar(pred_p, tgt_p, use_ssim=False)
        return reproj_loss(pred_p, tgt_p)

    target_p = _nchw(color[0])
    identity = None
    if not cfg.disable_automasking:
        identity = torch.cat([reproj_fn(_nchw(color[f]), target_p)
                              for f in sources], -1)

    losses: Dict[str, torch.Tensor] = {}
    outputs: Dict[str, object] = {"disp": disps}
    total_loss = 0.0
    for s in cfg.scales:
        disp_s = disps[s]
        disp_full = resize_bilinear(disp_s, h, w)
        _, depth = G.disp_to_depth(disp_full, cfg.min_depth, cfg.max_depth)
        cam_points = G.backproject(depth, inv_Ks)
        reprojs = []
        for f in sources:
            pix = G.project(cam_points, Ks, poses[f], h, w)
            if not (with_images or cfg.no_ssim):
                reprojs.append(warp_reproj_loss(raw[f], pix, target_p))
                continue
            warped_p = warp(raw[f], pix)[0]
            if with_images:
                outputs[f"color_pred/{f}/{s}"] = _nhwc(warped_p)
            reprojs.append(reproj_fn(warped_p, target_p))
        reproj = torch.cat(reprojs, -1)

        to_opt, automask = L.min_reprojection(
            reproj, identity, noise=None if noise is None else noise[s],
            generator=generator, avg_reprojection=cfg.avg_reprojection)
        if automask is not None and with_images:
            outputs[f"automask/{s}"] = automask
        min_loss = torch.mean(to_opt)
        smooth = L.smooth_loss(L.normalized_disp(disp_s), pyr0[s])
        loss_s = min_loss + cfg.disparity_smoothness * smooth / (2 ** s)
        losses[f"min_loss/{s}"] = min_loss
        losses[f"loss/{s}"] = loss_s
        total_loss = total_loss + loss_s
    total_loss = total_loss / cfg.num_scales
    losses["loss"] = total_loss
    return total_loss, (losses, outputs)


def build_eval_step(bundle: ModelBundle, with_images: bool = False):
    """-> step(batch, generator=None, noise=None) -> (losses, outputs): the
    validation forward with BatchNorm on its running statistics."""

    def step(batch, generator=None, noise=None):
        bundle.eval()
        with torch.inference_mode():
            _, (losses, outputs) = forward_and_loss(
                bundle, batch, train=False, with_images=with_images,
                generator=generator, noise=noise)
        return losses, outputs

    return step


def build_infer_step(bundle: ModelBundle):
    """-> infer(images) -> {scale: (B, h, w, 1) disparity}: the depth
    encoder and decoder only, on NHWC float images in [0, 1]."""

    def infer(images):
        bundle.eval()
        with torch.inference_mode():
            disps = bundle.depth(bundle.encoder(_nchw(images.float())))
        return {s: _nhwc(d) for s, d in disps.items()}

    return infer
