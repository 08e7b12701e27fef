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
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .. import tracing
from ..data.pipeline import process_local_rows
from ..ops import geometry as G
from ..ops import losses as L
from ..ops.augment_device import batch_augment
from ..ops.kernels import (add_counts, counts, grid_sample_fast,
                           reproj_loss_op, rung_counts, warp_op,
                           warp_reproj_loss_op)
from ..ops.kernels.warp import INV255
from ..ops.resize import image_pyramid, resize_bilinear
from ..ops.warp import grid_sample
from ..parallel.mesh import (Mesh, all_reduce_sum, average_gradients,
                             mean_over_ranks, share_batch_statistics)
from .bundle import ModelBundle
from .state import TrainState, full_params, is_capturable


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
                     noise: Optional[Dict[int, torch.Tensor]] = None,
                     mesh: Optional[Mesh] = None,
                     noise_rows: Optional[Tuple[int, int, int]] = None):
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
      mesh: the run's ``parallel.mesh.Mesh`` when ``batch`` is this rank's
        share of a global batch: the GAN prior's silog term is then taken
        over the global batch (BatchNorm's statistics follow the modules'
        ``stats_group``).
      noise_rows: (start, stop, global_batch): the rows of the global
        batch that ``batch`` holds; the noise drawn from ``generator`` is
        the global batch's, cut to them (``losses.tie_break_noise``).

    Returns (total_loss, (losses, outputs)); outputs['disp'] maps each
    scale to its (B, h, w, 1) disparity. The losses are this batch's; over
    a mesh, their mean over the ranks is the global batch's.
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
    silog_reduce = (None if mesh is None or mesh.size == 1
                    else lambda sums: all_reduce_sum(sums, mesh.group))

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
            generator=generator, avg_reprojection=cfg.avg_reprojection,
            noise_rows=noise_rows)
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
            gan = L.silog_loss(prior, disp_full, silog_reduce)
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


def draw_noise(cfg, batch_size: int, generator: torch.Generator, device
               ) -> Optional[Dict[int, torch.Tensor]]:
    """The automask tie-break noise that the training step's forward draws
    from ``generator`` when it is given none: for each of the
    ``cfg.grad_accum`` microbatches, one ``losses.tie_break_noise`` per
    scale in ``cfg.scales`` order, of the identity losses' shape (B / n, h,
    w, S), S being the number of source frames, or 1 under
    ``avg_reprojection``, and (h, w) the full size, or the scale's own
    under ``v1_multiscale``. -> {scale: (B, h, w, S)}, the microbatches'
    draws one after another, the same numbers as the forward's own draws;
    None without automasking (nothing is drawn)."""
    if cfg.disable_automasking:
        return None
    n = batch_size // cfg.grad_accum
    sources = 1 if cfg.avg_reprojection else (
        len(cfg.frame_ids) - 1 + (1 if cfg.use_stereo else 0))

    def shape(s):
        level = s if cfg.v1_multiscale else 0
        return (n, cfg.height >> level, cfg.width >> level, sources)

    draws = [{s: L.tie_break_noise(shape(s), generator, device)
              for s in cfg.scales} for _ in range(cfg.grad_accum)]
    return {s: torch.cat([d[s] for d in draws]) for s in cfg.scales}


def graph_capturable(cfg, device, mesh: Optional[Mesh] = None,
                     shards=None) -> bool:
    """Whether ``build_train_step``'s step runs from one CUDA graph (its
    Adam being ``capturable``, as ``state.adam_capturable`` makes it): on a
    CUDA device, in one process (no mesh, or a mesh of one process whose
    group, if any, is NCCL's: gloo's all-reduce of a device tensor goes
    through the host), without fsdp ``shards``, and with a forward that
    reads nothing back from the device once it has run. It reads the host
    under the warp ladders of ``pallas_warp_version`` below 8 (their gates
    read flags back), ``v1_multiscale`` (float frames through the ladder),
    ``predictive_mask`` (clip bounds made from host numbers) and the GAN
    prior's ``pre_trained_generator`` (the grey weights): those run
    eagerly."""
    return (torch.device(device).type == "cuda"
            and (mesh is None or (mesh.size == 1 and (
                mesh.group is None
                or dist.get_backend(mesh.group) == "nccl")))
            and shards is None
            and not (cfg.use_pallas_warp and cfg.pallas_warp_version < 8)
            and not (cfg.v1_multiscale or cfg.predictive_mask
                     or cfg.pre_trained_generator))


def _backend_flags() -> tuple:
    """The settings that choose the step's algorithms: a graph keeps the
    ones it was captured under."""
    return (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled())


class _StepGraph:
    """The training step of ``graph_capturable`` configurations, replayed
    from one ``torch.cuda.CUDAGraph``: the forward, the backward, the
    gradient norm and Adam's update (its ``capturable`` mode, its rate a
    device tensor filled from the schedule before each call).

    The first ``WARM`` calls with a given configuration, batch and noise
    layout and backend settings run eagerly on a side stream (PyTorch's
    whole-network warm-up); the next captures the step and replays it
    once; later ones copy the batch and the noise into the graph's static
    buffers and replay it. A change of any of those, or new storage of a
    parameter, buffer or Adam tensor (a loaded state), drops the graph and
    starts the warm-up again: a caller that loads a state before every
    call runs eagerly throughout. Without ``noise`` it is drawn before each
    call as the forward would draw it (``draw_noise``), so every call
    computes the eager step's numbers. Each replay adds the kernel
    launches and ladder rungs that the capture recorded to
    ``ops.kernels``' counts, as an eager call would."""

    WARM = 2

    def __init__(self, bundle: ModelBundle, update):
        self.bundle, self.update = bundle, update
        self.graph = self.key = self.storages = None
        self.watched = self.opt_state = None
        self.warm = 0
        self.lr = self.side = None
        self.batch = self.noise = self.packed = self.names = None
        self.launches = self.rungs = None

    def __call__(self, state: TrainState, batch, generator, noise):
        cfg = self.bundle.cfg
        device = batch["color"].device
        with tracing.span("step.inputs"):
            if self.lr is None or self.lr.device != device:
                self.lr = torch.zeros((), dtype=torch.float32, device=device)
            self.lr.fill_(state.schedule(state.step))
            if noise is None:
                if generator is None:
                    generator = noise_generator(cfg.seed, state.step, device)
                noise = draw_noise(cfg, batch["color"].shape[0], generator,
                                   device)
            key = (tuple(vars(cfg).values()),
                   [(k, v.shape, v.dtype, v.device) for k, v in batch.items()],
                   None if noise is None else
                   [(s, t.shape, t.dtype) for s, t in noise.items()],
                   _backend_flags())
            if key != self.key or self._moved(state):
                # a new layout, or new storage (a loaded state): the
                # warm-up again, then a capture
                self.graph, self.key, self.warm = None, key, 0
                self._watch(state)
            if self.graph is not None:
                self._copy_inputs(batch, noise)
        if self.graph is None and self.warm < self.WARM:
            self.warm += 1
            return self._eager(state, batch, generator, noise)
        if self.graph is None:
            self._capture(state, batch, generator, noise)
        if not self.bundle.training:
            self.bundle.train(True)
        with tracing.span("step.replay"):
            self.graph.replay()
        add_counts(self.launches, self.rungs)
        tracing.count("step.graph_replays")
        state.step += 1
        return dict(zip(self.names, self.packed.clone().unbind()))

    def _watch(self, state: TrainState):
        """Note the tensors the graph reads and writes: the bundle's
        parameters and buffers and Adam's state, and their storages."""
        opt = state.optimizer
        self.watched = [*self.bundle.parameters(), *self.bundle.buffers()]
        for st in opt.state.values():
            self.watched.extend(v for v in st.values() if torch.is_tensor(v))
        self.opt_state = opt.state
        self.storages = [t.data_ptr() for t in self.watched]

    def _moved(self, state: TrainState) -> bool:
        """Whether Adam's state was replaced (a load) or a watched tensor
        has new storage since ``_watch``."""
        return (self.watched is None
                or state.optimizer.state is not self.opt_state
                or [t.data_ptr() for t in self.watched] != self.storages)

    def _copy_inputs(self, batch, noise):
        for k, v in batch.items():
            self.batch[k].copy_(v, non_blocking=True)
        for s, t in (noise or {}).items():
            self.noise[s].copy_(t, non_blocking=True)

    def _eager(self, state: TrainState, batch, generator, noise):
        tracing.count("step.eager")
        current = torch.cuda.current_stream(batch["color"].device)
        if self.side is None or self.side.device != current.device:
            self.side = torch.cuda.Stream(current.device)
        self.side.wait_stream(current)
        with torch.cuda.stream(self.side):
            losses = self.update(state, batch, generator, noise, self.lr)
        current.wait_stream(self.side)
        for v in losses.values():
            v.record_stream(current)
        state.step += 1
        return losses

    def _capture(self, state: TrainState, batch, generator, noise):
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self.noise = (None if noise is None else
                      {s: torch.empty_like(t) for s, t in noise.items()})
        self._copy_inputs(batch, noise)
        for p in self.bundle.main_parameters():
            p.grad = None
        graph = torch.cuda.CUDAGraph()
        launches, rungs = counts(), rung_counts()
        # thread_local: other threads (the Loader's, waiting on its copy
        # events) may call CUDA while this one captures
        with tracing.span("step.capture"), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            losses = self.update(state, self.batch, generator, self.noise,
                                 self.lr)
            self.names = list(losses)
            self.packed = torch.stack([losses[k] for k in self.names])
        del losses
        # the capture ran nothing: its counts are the replays'
        self.launches = {k: n - launches[k] for k, n in counts().items()}
        self.rungs = {k: n - rungs[k] for k, n in rung_counts().items()}
        add_counts(self.launches, self.rungs, -1)
        self.graph = graph
        self._watch(state)
        tracing.count("step.graph_captures")


def build_train_step(bundle: ModelBundle, mesh: Optional[Mesh] = None):
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

    Over a ``mesh`` of processes ``batch`` is this rank's rows of the
    global batch (``data.pipeline.process_local_rows``: its share of each
    microbatch), ``noise`` is the global batch's, and the step computes
    what one device computes on the global batch: BatchNorm on the global
    statistics, the noise of the global draw, the gradients averaged over
    the ranks before the update, and losses and ``grad_norm`` global,
    the same on every rank. Under fsdp (``state.shards``) the full
    parameters are gathered for the step, Adam updates this rank's shard,
    and the full parameters are freed again.

    Where ``graph_capturable`` admits the call and Adam is ``capturable``
    (``state.adam_capturable``), the step is replayed from one CUDA graph
    after two eager calls (``_StepGraph``). The losses returned are the
    call's own:
    a later call leaves them as they are.

    Each call is a ``tracing`` span ``step``. An eager call holds
    ``step.forward`` (``forward_and_loss``) and ``step.backward`` for each
    microbatch, then ``step.optimizer`` (the mesh's averaging of the
    gradients and the losses, the microbatches' mean, ``grad_norm``, the
    learning rate and the update): the host's time enqueueing each phase.
    A graph's call holds ``step.inputs`` (the rate, the noise's draw and
    the copies into the graph's buffers) and ``step.replay``; the call
    that captures also ``step.capture``, with the phases inside it.
    Counters: ``step.eager``, ``step.graph_captures``,
    ``step.graph_replays``.
    """
    cfg = bundle.cfg
    accum = cfg.grad_accum
    world = 1 if mesh is None else mesh.size
    if mesh is not None and world > 1:
        share_batch_statistics(bundle, mesh.group)

    def step(state: TrainState, batch, generator=None, noise=None):
        with tracing.span("step"):
            if (graph_capturable(cfg, batch["color"].device, mesh,
                                 state.shards)
                    and is_capturable(state.optimizer)):
                return graph(state, batch, generator, noise)
            tracing.count("step.eager")
            losses = _update(state, batch, generator, noise,
                             state.schedule(state.step))
            state.step += 1
            return losses

    def _update(state: TrainState, batch, generator, noise, lr):
        """Forward and backward of each microbatch, then the update at
        rate ``lr`` (a float, or a capturable Adam's device tensor); -> the
        losses."""
        b = batch["color"].shape[0]
        if accum < 1 or b % accum:
            raise ValueError(f"grad_accum {accum} does not divide the batch "
                             f"of {b}")
        opt = state.optimizer
        if noise is None and generator is None:
            generator = noise_generator(cfg.seed, state.step,
                                        batch["color"].device)
        if noise is not None and world > 1:
            rows = torch.from_numpy(process_local_rows(mesh, b * world,
                                                       accum))
            noise = {s: t[rows.to(t.device)] for s, t in noise.items()}
        shards = state.shards
        if shards is not None:
            shards.gather()
        params = bundle.main_parameters()
        for p in params:
            p.grad = None
        n = b // accum
        noise_rows = _rank_rows(mesh, n)
        per_micro = []
        for i in range(accum):
            part = slice(i * n, (i + 1) * n)
            micro = {k: v[part] for k, v in batch.items()}
            micro_noise = (None if noise is None
                           else {s: t[part] for s, t in noise.items()})
            with tracing.span("step.forward"):
                total, (losses, _) = forward_and_loss(
                    bundle, micro, train=True, generator=generator,
                    noise=micro_noise, mesh=mesh, noise_rows=noise_rows)
            with tracing.span("step.backward"):
                total.backward()
                per_micro.append({k: v.detach() for k, v in losses.items()})
                # the graph goes here, not when the step returns
                del total, losses, _
        with tracing.span("step.optimizer"):
            flat = None
            if mesh is not None:
                flat = average_gradients(
                    params, mesh,
                    numel=None if shards is None else shards.numel,
                    zeros_for_missing=shards is not None)
            if accum > 1:
                for p in params:
                    p.grad.div_(accum)
            losses = {k: torch.stack([m[k] for m in per_micro]).mean()
                      for k in per_micro[0]}
            if mesh is not None:
                losses = mean_over_ranks(losses, mesh)
            losses["grad_norm"] = global_norm([p.grad for p in params])
            for group in opt.param_groups:
                group["lr"] = lr
            if shards is None:
                opt.step()
            else:
                shards.step(opt, flat)
        return losses

    graph = _StepGraph(bundle, _update)
    return step


def _rank_rows(mesh: Optional[Mesh], n: int):
    """(start, stop, global rows) of this rank's ``n`` rows of a global
    (micro)batch of ``n * mesh.size`` (``Mesh.batch_slices``); None on one
    process."""
    if mesh is None or mesh.size == 1:
        return None
    rows = mesh.batch_slices(n * mesh.size)[0]
    return rows.start, rows.stop, n * mesh.size


def build_disc_step(bundle: ModelBundle, mesh: Optional[Mesh] = None):
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
    network). Over a ``mesh`` each rank runs its rows, and the gradients
    and the loss are averaged over the ranks (the discriminator's
    instance norms need no statistics of other rows)."""
    disc = bundle.discriminator
    if disc is None:
        raise ValueError("build_disc_step needs adversarial_prior")

    def step(state: TrainState, batch, real=None):
        with torch.no_grad(), full_params(state):
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
        losses = {"disc_loss": loss.detach()}
        if mesh is not None:
            average_gradients(disc.parameters(), mesh)
            losses = mean_over_ranks(losses, mesh)
        opt.step()
        return losses

    return step


def build_eval_step(bundle: ModelBundle, with_images: bool = False,
                    mesh: Optional[Mesh] = None):
    """-> step(batch, generator=None, noise=None) -> (losses, outputs): the
    validation forward with BatchNorm on its running statistics. Over a
    ``mesh`` ``batch`` is this rank's contiguous block of the global
    batch, the noise drawn from ``generator`` the global batch's, and the
    losses the global batch's (the outputs are this rank's rows; ``noise``,
    when given, is the global batch's). Under fsdp the caller gathers the
    parameters (``train.state.full_params``)."""

    def step(batch, generator=None, noise=None):
        b = batch["color"].shape[0]
        rows = _rank_rows(mesh, b)
        if noise is not None and rows is not None:
            noise = {s: t[rows[0]:rows[1]] for s, t in noise.items()}
        with torch.inference_mode():
            _, (losses, outputs) = forward_and_loss(
                bundle, batch, train=False, with_images=with_images,
                generator=generator, noise=noise, mesh=mesh,
                noise_rows=rows)
            if mesh is not None:
                losses = mean_over_ranks(losses, mesh)
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
