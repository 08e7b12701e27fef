"""The training step, the validation step and the depth-inference step.

Port of ``unsupervised_pose_estimation_tpu/train/step.py``:
``forward_and_loss``, ``build_train_step`` (forward, loss, backward, Adam),
``build_eval_step`` (the reference trainer's ``val()``) and
``build_infer_step``, for the configurations
``train.bundle.check_supported`` admits. On a CUDA device the photometric
terms run in the port's kernels. For every scale and source frame: with
``use_pallas_warp_loss`` (the default) the fused warp + loss (K1) and, in
training, its backward (K2); without it, when the warped images are
returned, or under ``v1_multiscale``, the warp followed by the SSIM + L1
loss (K3) and, in training, K3's backward (K4). The identity (automask)
terms run K3 with no gradient.

The warp: a uint8 frame at ``pallas_warp_version`` 8 runs K5 at any shape.
Below version 8, and for the float pyramid levels ``v1_multiscale`` warps,
a warp whose size meets the reference's gate (W % 128 == 0, H % 8 == 0,
H >= 16) goes through that version's ladder (``ops.kernels.
grid_sample_fast``: the corner-fetch kernels K6-K8, or a plain gather),
any other through the plain ``ops.warp.grid_sample``; the fused op needs
version 8. ``use_pallas_warp=False`` sends every warp to the plain
``grid_sample``, ``use_pallas_loss=False`` every loss to the plain
``ops.losses.reprojection_loss_planar``, and either one turns the fused op
off, as in the reference. The networks compute at ``cfg.compute_dtype``;
their disparities, masks and poses, and everything after them, are
float32.

With ``pre_trained_generator`` the frozen GAN generator's disparity of the
target's grey frame is a prior that each scale's disparity is held to by
the scale-invariant log loss (``gan_loss/{s}``; the total gains their sum
over the number of scales times 0.002); with ``adversarial_prior``,
``build_disc_step`` trains the PatchGAN discriminator on the generator's
disparities against the depth network's. Both are cuDNN convolutions and
plain ops: the reference has no kernel of its own there.
``bundle.generator`` is that network; a step's ``generator=`` keyword is
the ``torch.Generator`` of the automask noise.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import torch

from ..ops import geometry as G
from ..ops import losses as L
from ..ops.augment_device import batch_augment
from ..ops.kernels import (grid_sample_fast, reproj_loss_op, warp_op,
                           warp_reproj_loss_op)
from ..ops.kernels.warp import INV255
from ..ops.resize import image_pyramid, resize_bilinear
from ..ops.warp import grid_sample
from .bundle import ModelBundle
from .state import TrainState


def _f32(x):
    """uint8 [0, 255] -> float32 [0, 1]; float input as float32."""
    if x.dtype == torch.uint8:
        return x.float() * (1.0 / 255.0)
    return x.float()


def _grayscale(img):
    """ITU-R 601 luma of NHWC ``img`` (torchvision ``Grayscale``, the
    reference trainer's): (B, H, W, 3) -> (B, H, W, 1)."""
    w = torch.tensor([0.2989, 0.587, 0.114], dtype=img.dtype,
                     device=img.device)
    return torch.sum(img * w, dim=-1, keepdim=True)


def gan_prior(bundle: ModelBundle, color0):
    """The frozen generator's disparity of the grey of ``color0`` (the
    un-augmented target, NHWC float in [0, 1]): (B, 1, H, W) float32,
    negative where the generator's depth is."""
    with torch.no_grad():
        fake = bundle.generator(_nchw(_grayscale(color0)))
    return G.depth_to_disp(fake)[1]


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _check_float32(**tensors):
    """The networks return float32 disparities and poses at any compute
    dtype (the reference's float32 sigmoid and pose mean), so the loss and
    the kernels, which take float32 only, never see bfloat16."""
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the loss takes float32")


def pose_parameters(bundle: ModelBundle, aug: Dict[int, torch.Tensor],
                    features_by_frame=None):
    """The pose network's output for every temporal source frame f: {f:
    (axisangle (B, 1, 3), translation (B, 1, 3), invert)}, ``invert`` being
    whether ``G.transformation_from_parameters`` inverts it.

    Pairs (``pose_model_input="pairs"``) go through a ``separate_resnet`` or
    ``posecnn`` network in one forward, stacked on the batch axis, so
    BatchNorm sees them together (as in the reference), and through a
    ``shared`` decoder one pair at a time as lists of the depth encoder's
    features (``features_by_frame``); the pose of a frame before the target
    is inverted. Under ``"all"`` every frame goes in at once, and no pose is
    inverted."""
    cfg = bundle.cfg
    sources = list(cfg.frame_ids[1:])
    pair = cfg.num_pose_frames == 2
    if cfg.pose_model_type == "shared":
        feats = features_by_frame
        if pair:
            out = {}
            for f in sources:
                aa, tt = bundle.pose([feats[f], feats[0]] if f < 0
                                     else [feats[0], feats[f]])
                out[f] = (aa[:, 0], tt[:, 0], f < 0)
            return out
        aa, tt = bundle.pose([feats[f] for f in cfg.frame_ids])
    else:
        # frames on the channel axis: each pair, earlier frame first,
        # stacked on the batch axis, or every frame in frame_ids order
        x = (torch.cat([torch.cat([aug[f], aug[0]] if f < 0
                                  else [aug[0], aug[f]], 1)
                        for f in sources], 0) if pair
             else torch.cat([aug[f] for f in cfg.frame_ids], 1))
        if cfg.pose_model_type == "separate_resnet":
            aa, tt = bundle.pose([bundle.pose_encoder(x)])
        else:
            aa, tt = bundle.pose(x)
    if not pair:
        return {f: (aa[:, i:i + 1, 0], tt[:, i:i + 1, 0], False)
                for i, f in enumerate(sources)}
    b = aug[0].shape[0]
    return {f: (aa[k * b:(k + 1) * b, 0], tt[k * b:(k + 1) * b, 0], f < 0)
            for k, f in enumerate(sources)}


def predict_poses(bundle: ModelBundle, aug: Dict[int, torch.Tensor],
                  features_by_frame=None):
    """cam_T_cam (B, 4, 4) for every temporal source frame
    (``pose_parameters``)."""
    return {f: G.transformation_from_parameters(aa[:, 0], tt[:, 0],
                                                invert=inv)
            for f, (aa, tt, inv) in pose_parameters(
                bundle, aug, features_by_frame).items()}


def forward_and_loss(bundle: ModelBundle, batch, train: bool = False,
                     with_images: bool = False,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Dict[int, torch.Tensor]] = None):
    """Depth, pose, view synthesis and the monodepth2 loss for one batch.

    Args:
      batch: {'color': uint8 (B, F, H, W, 3), 'K_norm': (B, 4, 4), and
        either 'color_aug': uint8 (B, F, H, W, 3) or 'aug_params': (B, 6)
        jitter factors that ``batch_augment`` turns into color_aug}, frames
        in ``frame_ids`` order, then the stereo frame with ``use_stereo``,
        which also needs 'stereo_T': (B, 4, 4).
      train: BatchNorm on batch statistics (updating its running ones) and
        a loss that gradients flow from; else BatchNorm on its running
        statistics.
      with_images: also return the warped sources ('color_pred/f/s') and
        the automasks (evaluation only); the warp then runs unfused.
      generator: the ``torch.Generator`` that draws the 1e-5 tie-break
        noise of the automask (the GAN prior's network is
        ``bundle.generator``).
      noise: {scale: (B, h, w, S)} tie-break noise to use instead (tests
        pass the reference package's draw), S being the number of source
        frames and (h, w) the full size, or the scale's own under
        ``v1_multiscale``.

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
    frame_ids = list(cfg.frame_ids) + (["s"] if cfg.use_stereo else [])
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

    # pyramids: frame 0's for the smoothness; every frame's when the
    # warps run at each scale's own size
    multi = cfg.v1_multiscale
    n_levels = max(cfg.scales) + 1
    pyr = {0: image_pyramid(color[0], n_levels)}
    if multi:
        for f in sources:
            pyr[f] = image_pyramid(color[f], n_levels)
    K_norm = batch["K_norm"].float()
    Ks = [G.scaled_intrinsics(K_norm, w, h, s) for s in range(n_levels)]
    inv_Ks = [G.invert_intrinsics(K) for K in Ks]

    feats_by_frame = None
    if cfg.pose_model_type == "shared":
        # every frame through the depth encoder in one forward, so its
        # BatchNorm sees them together (as in the reference)
        b = aug[0].shape[0]
        stacked = bundle.encoder(torch.cat([aug[f] for f in cfg.frame_ids],
                                           0))
        feats_by_frame = {f: [fm[i * b:(i + 1) * b] for fm in stacked]
                          for i, f in enumerate(cfg.frame_ids)}
        features = feats_by_frame[0]
    else:
        features = bundle.encoder(aug[0])
    disps = {s: _nhwc(d) for s, d in bundle.depth(features).items()}
    pose_params = (pose_parameters(bundle, aug, feats_by_frame)
                   if cfg.use_pose_net else {})
    masks = None
    if cfg.predictive_mask:
        masks = {s: _nhwc(m)
                 for s, m in bundle.predictive_mask(features).items()}
    prior = (_nhwc(gan_prior(bundle, color[0]))
             if cfg.pre_trained_generator else None)
    _check_float32(**{f"disp/{s}": d for s, d in disps.items()},
                   **{f"pose/{f}": p[0] for f, p in pose_params.items()})

    loss_kernel = cfg.use_pallas_loss and not cfg.no_ssim

    def reproj_fn(pred_p, tgt_p):
        if loss_kernel:
            return reproj_loss_op(pred_p, tgt_p)
        return L.reprojection_loss_planar(pred_p, tgt_p,
                                          use_ssim=not cfg.no_ssim)

    version = cfg.pallas_warp_version
    fused = (cfg.use_pallas_warp_loss and cfg.use_pallas_warp and loss_kernel
             and version >= 8 and not (with_images or multi))

    def warp_fn(src, pix):
        sh, sw = pix.shape[2], pix.shape[3]
        if cfg.use_pallas_warp:
            if version >= 8 and src.dtype == torch.uint8:
                return warp_op(src, pix)[0]
            if sw % 128 == 0 and sh % 8 == 0 and sh >= 16:
                return grid_sample_fast(src, pix, planar_out=True,
                                        version=version, planar_grid=True)
        scale = INV255 if src.dtype == torch.uint8 else 1.0
        return _nchw(grid_sample(src, pix) * scale)

    def identity_losses(s):
        """The identity (automask) losses of every source at scale s, from
        the input frames only: no gradient, as the reference's
        stop_gradient."""
        with torch.no_grad():
            if multi:
                tgt = _nchw(pyr[0][s])
                return torch.cat([reproj_fn(_nchw(pyr[f][s]), tgt)
                                  for f in sources], -1)
            tgt = _nchw(color[0])
            return torch.cat([reproj_fn(_nchw(color[f]), tgt)
                              for f in sources], -1)

    # without v1_multiscale every scale compares the same full-size frames
    identity = (None if cfg.disable_automasking or multi
                else identity_losses(0))

    losses: Dict[str, torch.Tensor] = {}
    outputs: Dict[str, object] = {"disp": disps}
    total_loss = gan_total = 0.0
    for s in cfg.scales:
        src_s = s if multi else 0
        sh, sw = h >> src_s, w >> src_s
        disp_s = disps[s]
        disp_full = disp_s if multi else resize_bilinear(disp_s, h, w)
        _, depth = G.disp_to_depth(disp_full, cfg.min_depth, cfg.max_depth)
        cam_points = G.backproject(depth, inv_Ks[src_s])
        target_p = _nchw(pyr[0][s] if multi else color[0])
        reprojs = []
        for f in sources:
            if f == "s":
                T = batch["stereo_T"].float()
            else:
                aa, tt, inv = pose_params[f]
                if cfg.pose_model_type == "posecnn":
                    # SfMLearner's rescale by the mean inverse depth, with
                    # the pair's invert rule under "all" too (as the
                    # reference trainer)
                    mean_inv_depth = torch.mean(1.0 / depth, dim=(1, 2, 3))
                    tt = tt * mean_inv_depth[:, None, None]
                    inv = f < 0
                T = G.transformation_from_parameters(aa[:, 0], tt[:, 0],
                                                     invert=inv)
            pix = G.project(cam_points, Ks[src_s], T, sh, sw)
            if fused:
                reprojs.append(warp_reproj_loss_op(raw[f], pix, target_p))
                continue
            warped_p = warp_fn(pyr[f][s] if multi else raw[f], pix)
            if with_images:
                outputs[f"color_pred/{f}/{s}"] = _nhwc(warped_p)
            reprojs.append(reproj_fn(warped_p, target_p))
        reproj = torch.cat(reprojs, -1)

        loss_s = 0.0
        if masks is not None:
            mask = masks[s] if multi else resize_bilinear(masks[s], h, w)
            reproj = reproj * mask
            # 0.2 * BCE(mask, 1); minimum/maximum differentiate as jnp.clip
            clipped = torch.minimum(torch.maximum(
                mask, mask.new_tensor(1e-7)), mask.new_tensor(1.0))
            loss_s = 0.2 * torch.mean(-torch.log(clipped))
        if multi and not cfg.disable_automasking:
            identity = identity_losses(s)
        to_opt, automask = L.min_reprojection(
            reproj, identity, noise=None if noise is None else noise[s],
            generator=generator, avg_reprojection=cfg.avg_reprojection)
        if automask is not None and with_images:
            outputs[f"automask/{s}"] = automask
        min_loss = torch.mean(to_opt)
        smooth = L.smooth_loss(L.normalized_disp(disp_s), pyr[0][s])
        loss_s = loss_s + min_loss + cfg.disparity_smoothness * smooth / (
            2 ** s)
        losses[f"min_loss/{s}"] = min_loss
        losses[f"loss/{s}"] = loss_s
        total_loss = total_loss + loss_s
        if prior is not None:
            gan = L.silog_loss(prior, disp_full)
            losses[f"gan_loss/{s}"] = gan
            gan_total = gan_total + gan
    total_loss = total_loss / cfg.num_scales
    if prior is not None:
        total_loss = total_loss + gan_total / cfg.num_scales * 0.002
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
    ``losses['grad_norm']`` is the global L2 norm of the gradients of
    ``bundle.main_parameters()``, the parameters the update moves.

    The automask noise is ``noise`` ({scale: (B, H, W, S)} for the whole
    batch) if given, else drawn from ``generator``, else from
    ``noise_generator(cfg.seed, state.step)`` (``generator`` is a
    ``torch.Generator``; the GAN prior's network is ``bundle.generator``).
    The update is ``state.optimizer``'s (``create_train_state(bundle)``),
    at the learning rate ``state.schedule(state.step)``.
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
        params = bundle.main_parameters()
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


def build_disc_step(bundle: ModelBundle):
    """-> step(state, batch, real=None) -> {'disc_loss': ...}: one update
    of the PatchGAN discriminator by ``state.disc_optimizer`` (the
    reference trainer's discriminator pass as the reference package fixes
    it): real samples are the frozen generator's disparities of the
    un-augmented target (``gan_prior``), or ``real`` (B, 1, H, W) when
    given (tests pass the reference package's), fake ones the depth
    network's scale-0 disparities of it with BatchNorm on its running
    statistics, neither differentiated; the loss is 0.5 * (mean((D(real)
    - 1)^2) + mean(D(fake)^2)). Run it after the training step, on the
    same batch. It draws no random numbers, so it takes no
    ``torch.Generator`` (``bundle.generator`` is the GAN prior's
    network)."""
    disc = bundle.discriminator
    if disc is None:
        raise ValueError("build_disc_step needs adversarial_prior")

    def step(state: TrainState, batch, real=None):
        with torch.no_grad():
            color0 = _f32(batch["color"][:, 0])
            if real is None:
                real = gan_prior(bundle, color0)
            bundle.train(False)
            fake = bundle.depth(bundle.encoder(_nchw(color0)))[0]
        loss = 0.5 * (torch.mean((disc(real) - 1.0) ** 2)
                      + torch.mean(disc(fake) ** 2))
        opt = state.disc_optimizer
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return {"disc_loss": loss.detach()}

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
