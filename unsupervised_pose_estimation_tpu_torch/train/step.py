"""The training step, the validation step and the depth-inference step.

Port of ``unsupervised_pose_estimation_tpu/train/step.py``:
``forward_and_loss``, ``build_train_step`` (forward, loss, backward, Adam),
``build_eval_step`` (the reference trainer's ``val()``) and
``build_infer_step``, for the configurations
``train.bundle.check_supported`` admits. On a CUDA device the photometric
terms run in the port's kernels. For every scale and source frame: with
``use_pallas_warp_loss`` (the default) the fused warp + loss (K1) and, in
training, its backward (K2); without it, or when the warped images are
returned, the warp (K5) followed by the SSIM + L1 loss (K3) and, in
training, K3's backward (K4). The identity (automask) terms run K3 with no
gradient.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import torch

from ..ops import geometry as G
from ..ops import losses as L
from ..ops.augment_device import batch_augment
from ..ops.kernels import reproj_loss_op, warp_op, warp_reproj_loss_op
from ..ops.resize import image_pyramid, resize_bilinear
from .bundle import ModelBundle
from .state import TrainState


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
      batch: {'color': uint8 (B, F, H, W, 3), 'K_norm': (B, 4, 4), and
        either 'color_aug': uint8 (B, F, H, W, 3) or 'aug_params': (B, 6)
        jitter factors that ``batch_augment`` turns into color_aug}, frames
        in ``frame_ids`` order.
      train: BatchNorm on batch statistics (updating its running ones) and
        a loss that gradients flow from; else BatchNorm on its running
        statistics.
      with_images: also return the warped sources ('color_pred/f/s') and
        the automasks (evaluation only); the warp then runs unfused.
      generator: draws the 1e-5 tie-break noise of the automask.
      noise: {scale: (B, H, W, S)} tie-break noise to use instead (tests
        pass the reference package's draw).

    Returns (total_loss, (losses, outputs)); outputs['disp'] maps each
    scale to its (B, h, w, 1) disparity.
    """
    if train and with_images:
        raise ValueError("with_images is for evaluation only")
    bundle.train(train)
    cfg = bundle.cfg
    h, w = cfg.height, cfg.width
    if batch["color"].dtype != torch.uint8:
        raise TypeError("batch['color'] must be uint8")
    frame_ids = list(cfg.frame_ids)
    sources = frame_ids[1:]
    f_index = {f: i for i, f in enumerate(frame_ids)}
    raw = {f: batch["color"][:, f_index[f]].contiguous() for f in frame_ids}
    color = {f: _f32(raw[f]) for f in frame_ids}
    if "aug_params" in batch:
        aug_all = batch_augment(batch["color"], batch["aug_params"])
        aug = {f: _nchw(aug_all[:, f_index[f]]) for f in frame_ids}
    else:
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
        return reproj_loss_op(pred_p, tgt_p)

    fused = cfg.use_pallas_warp_loss and not (with_images or cfg.no_ssim)
    target_p = _nchw(color[0])
    identity = None
    if not cfg.disable_automasking:
        # input frames only: no gradient, as the reference's stop_gradient
        with torch.no_grad():
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
            if fused:
                reprojs.append(warp_reproj_loss_op(raw[f], pix, target_p))
                continue
            warped_p = warp_op(raw[f], pix)[0]
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


def noise_generator(seed: int, step: int, device) -> torch.Generator:
    """The automask noise generator of training step ``step``: a function
    of (seed, step) only, so a resumed run draws the same noise (the
    reference folds the step into its key). The two are hashed together,
    because the CPU generator keeps only the low 32 bits of a seed."""
    digest = hashlib.blake2b(f"{seed}:{step}".encode(), digest_size=8)
    return torch.Generator(device).manual_seed(
        int.from_bytes(digest.digest(), "little"))


def global_norm(tensors) -> torch.Tensor:
    """L2 norm of all the tensors together (optax ``global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t) for t in tensors]))


def build_train_step(bundle: ModelBundle):
    """-> step(state, batch, generator=None, noise=None) -> losses: one
    training step of ``state`` (forward with BatchNorm on batch statistics,
    loss, backward, one Adam update; ``state`` and the bundle are updated in
    place and ``state.step`` advances by one).

    With ``cfg.grad_accum`` = n > 1 the batch is cut into n microbatches
    along its first axis, each runs forward and backward in turn (the
    BatchNorm statistics carry from one to the next) and the update uses
    the mean of their gradients; the losses are the microbatches' means.
    ``losses['grad_norm']`` is the global L2 norm of the gradients.

    The automask noise is ``noise`` ({scale: (B, H, W, S)} for the whole
    batch) if given, else drawn from ``generator``, else from
    ``noise_generator(cfg.seed, state.step)``. The update is
    ``state.optimizer``'s (``create_train_state(bundle)``), at the learning
    rate ``state.schedule(state.step)``.
    """
    cfg = bundle.cfg
    accum = cfg.grad_accum

    def step(state: TrainState, batch, generator=None, noise=None):
        if accum < 1 or batch["color"].shape[0] % accum:
            raise ValueError(f"grad_accum {accum} does not divide the batch "
                             f"of {batch['color'].shape[0]}")
        opt = state.optimizer
        if noise is None and generator is None:
            generator = noise_generator(cfg.seed, state.step,
                                        batch["color"].device)
        params = [p for p in bundle.parameters() if p.requires_grad]
        opt.zero_grad(set_to_none=True)
        n = batch["color"].shape[0] // accum
        per_micro = []
        for i in range(accum):
            part = slice(i * n, (i + 1) * n)
            micro = {k: v[part] for k, v in batch.items()}
            micro_noise = (None if noise is None
                           else {s: t[part] for s, t in noise.items()})
            total, (losses, _) = forward_and_loss(
                bundle, micro, train=True, generator=generator,
                noise=micro_noise)
            total.backward()
            per_micro.append({k: v.detach() for k, v in losses.items()})
        if accum > 1:
            for p in params:
                p.grad.div_(accum)
        losses = {k: torch.stack([m[k] for m in per_micro]).mean()
                  for k in per_micro[0]}
        losses["grad_norm"] = global_norm([p.grad for p in params])
        for group in opt.param_groups:
            group["lr"] = state.schedule(state.step)
        opt.step()
        state.step += 1
        return losses

    return step


def build_eval_step(bundle: ModelBundle, with_images: bool = False):
    """-> step(batch, generator=None, noise=None) -> (losses, outputs): the
    validation forward with BatchNorm on its running statistics."""

    def step(batch, generator=None, noise=None):
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
