"""Trainer: data, training steps, validation, logging and checkpoints.

Port of ``unsupervised_pose_estimation_tpu/train/loop.py`` with the same
structure. Every random stream is a function of the seed
and the global step: the training step's automask noise comes from
``noise_generator(seed, step)``, validation's from ``(seed + 2, step)``,
and the Loader's shuffle and item draws from the seed, the epoch and the
index. So a run resumed from a checkpoint at step N replays the batches and
the noise of an uninterrupted run from step N on; and ``train()`` runs
cuDNN's deterministic algorithms (``deterministic_cudnn``), so that on the
card it also computes the same steps, bit for bit. With
``adversarial_prior`` every training step is followed by one
discriminator update on the same batch (``build_disc_step``), whose Adam
moments the checkpoints carry too.

Over the processes of a default process group (``torchrun``; see
``cli.train``) the ``mesh_*`` options lay out the reference's (dcn, data,
fsdp) mesh (``parallel.mesh.make_mesh``): each rank builds and trains on
its rows of every global batch, the steps compute the global batch's
losses and update, checkpoints are written by rank 0, and only rank 0
prints and logs. Without a group the trainer runs on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Options
from ..data.datasets import (SyntheticDataset, SyntheticParallaxDataset,
                             make_dataset)
from ..data.pipeline import Loader, process_local_rows
from ..data.split import readlines, resolve_split_file
from ..ops.geometry import disp_to_depth
from ..ops.kernels import _lib
from ..parallel.mesh import all_gather, make_mesh, rank_device
from . import checkpoint as ck
from .bundle import ModelBundle
from .logging import MetricLogger, Profiler
from .state import create_train_state, full_params, shard_train_state
from .step import (build_disc_step, build_eval_step, build_train_step,
                   noise_generator)

_REPO_SPLITS = os.path.join(os.path.dirname(__file__), "..", "..", "splits")


def _split_path(split: str, mode: str, split_dir: Optional[str] = None
                ) -> str:
    return resolve_split_file(split_dir or _REPO_SPLITS, split, mode)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it is a CUDA device and none
    is found (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "on the CPU")
    return device


def float32_setting(cfg: Options) -> str:
    """At ``compute_dtype="float32"`` turn TF32 off for matmuls and cuDNN's
    convolutions (cuDNN's default is on), so that float32 means float32 on
    the card; -> the setting, for the log."""
    if cfg.compute_dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return (f"compute dtype {cfg.compute_dtype}; TF32 matmul "
            f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
            f"{torch.backends.cudnn.allow_tf32}")


@contextlib.contextmanager
def deterministic_cudnn():
    """Restrict cuDNN to algorithms that sum in a fixed order while the body
    runs, then restore the setting (the flag is process-wide). With them,
    and the networks' deterministic reflect-pad backward
    (``models.layers.reflect_pad1``), the same parameters, batch and noise
    give the same training step on the card, so a resumed run repeats an
    uninterrupted one bit for bit."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


class Trainer:
    def __init__(self, options: Options, lr: Optional[float] = None,
                 sampling: Optional[int] = None, device="cuda"):
        # the reference entry point overrides lr and sampling positionally
        cfg = options
        if lr is not None:
            cfg = dataclasses.replace(cfg, learning_rate=lr)
        if sampling is not None:
            cfg = dataclasses.replace(cfg, sampling_frequency=sampling)
        cfg.validate()
        self.cfg = cfg
        self.mesh = make_mesh(cfg.mesh_data, cfg.mesh_fsdp, dcn=cfg.mesh_dcn)
        n_dev = self.mesh.size
        if cfg.batch_size % (n_dev * cfg.grad_accum) != 0:
            raise ValueError(
                f"batch_size ({cfg.batch_size}) must be divisible by "
                f"mesh size x grad_accum ({n_dev} devices x "
                f"{cfg.grad_accum}); adjust --batch_size / --mesh_data / "
                f"--grad_accum")
        self.device = resolve_device(rank_device(device))
        self.rank = self.mesh.rank

        if cfg.debug_nans:
            torch.autograd.set_detect_anomaly(True)

        self.say(f"learning rate {cfg.learning_rate} "
                 f"sampling frequency : {cfg.sampling_frequency}")
        self.say(float32_setting(cfg))
        self.say("cuDNN deterministic algorithms while training")
        if n_dev > 1:
            self.say(f"mesh dcn x data x fsdp = {cfg.mesh_dcn} x "
                     f"{self.mesh.data} x {cfg.mesh_fsdp} over {n_dev} "
                     f"processes; {cfg.batch_size // n_dev} rows each")

        self.log_path = os.path.join(cfg.log_dir, cfg.model_name)
        os.makedirs(self.log_path, exist_ok=True)

        self.bundle = ModelBundle.create(cfg, seed=cfg.seed,
                                         device=self.device)

        # data ---------------------------------------------------------
        frame_ids = list(cfg.frame_ids) + (["s"] if cfg.use_stereo else [])
        if cfg.synthetic_data or cfg.dataset in ("synthetic",
                                                 "synthetic_parallax"):
            ds_cls = (SyntheticParallaxDataset
                      if cfg.dataset == "synthetic_parallax"
                      else SyntheticDataset)
            n_items = max(4 * cfg.batch_size,
                          (cfg.steps_per_epoch or 4) * cfg.batch_size)
            extra = ({"cache_items": True,
                      "with_rotation": cfg.synthetic_rotation}
                     if ds_cls is SyntheticParallaxDataset else {})
            train_ds = ds_cls(n_items, cfg.height, cfg.width, frame_ids,
                              sampling_frequency=cfg.sampling_frequency,
                              **extra)
            # parallax validation items carry exact depth, so the depth
            # metrics are logged with no files at all
            val_ds = ds_cls(2 * cfg.batch_size, cfg.height, cfg.width,
                            frame_ids, is_train=False, seed=1,
                            load_depth=True, **extra)
        else:
            # boundary frames go, per sampling stride
            sf = cfg.sampling_frequency
            train_files = readlines(
                _split_path(cfg.split, "train", cfg.split_dir))[sf:-sf]
            val_files = readlines(
                _split_path(cfg.split, "val", cfg.split_dir))[sf:-sf]
            common = dict(height=cfg.height, width=cfg.width,
                          frame_idxs=frame_ids, img_ext=".png",
                          sampling_frequency=sf, seed=cfg.seed,
                          device_augment=cfg.device_augment,
                          native=_lib.native_route(self.device))
            train_ds = make_dataset(cfg.dataset, data_path=cfg.data_path,
                                    filenames=train_files, is_train=True,
                                    **common)
            val_ds = make_dataset(cfg.dataset, data_path=cfg.data_path,
                                  filenames=val_files, is_train=False,
                                  load_depth=True, **common)
            if train_ds.native:
                # built (or raising) here, so that process workers load it
                # and none of them builds it
                _lib.library()
            if cfg.frame_cache:
                # pre-decoded uint8 frames, train and val side by side
                from ..data.cache import attach_frame_cache

                attach_frame_cache(train_ds,
                                   os.path.join(cfg.frame_cache, "train"),
                                   build_if_missing=True)
                attach_frame_cache(val_ds,
                                   os.path.join(cfg.frame_cache, "val"),
                                   build_if_missing=True)

        # each rank builds its rows of every global batch
        mesh = self.mesh if n_dev > 1 else None
        self.train_loader = Loader(
            train_ds, cfg.batch_size, shuffle=True, device=self.device,
            num_workers=cfg.num_workers,
            num_worker_procs=cfg.num_worker_procs, prefetch=cfg.prefetch,
            seed=cfg.seed, rows=None if mesh is None else process_local_rows(
                mesh, cfg.batch_size, cfg.grad_accum))
        self.val_loader = Loader(
            val_ds, cfg.batch_size, shuffle=True, device=self.device,
            num_workers=max(2, cfg.num_workers // 2), prefetch=1,
            seed=cfg.seed, infinite=True,
            rows=None if mesh is None else process_local_rows(
                mesh, cfg.batch_size))
        self.val_iter = iter(self.val_loader)

        steps_per_epoch = cfg.steps_per_epoch or len(self.train_loader)
        self.steps_per_epoch = min(steps_per_epoch, len(self.train_loader))
        self.num_total_steps = self.steps_per_epoch * cfg.num_epochs

        # every rank loads the same weights; then the state is placed on
        # the mesh (under fsdp each rank keeps its shard)
        self.state = create_train_state(self.bundle, self.steps_per_epoch)
        self._init_encoders()
        self._load_initial_weights()
        self._load_generator()
        self.state = shard_train_state(self.state, self.bundle, self.mesh)

        self.train_step = build_train_step(self.bundle, self.mesh)
        self.eval_step = build_eval_step(self.bundle,
                                         with_images=cfg.log_images,
                                         mesh=self.mesh)
        self.disc_step = (build_disc_step(self.bundle, self.mesh)
                          if cfg.adversarial_prior else None)

        self.logger = MetricLogger(
            cfg.log_dir, cfg.model_name, use_wandb=cfg.wandb,
            jsonl=cfg.log_jsonl, config=cfg.__dict__,
            total_steps=self.num_total_steps, rank=self.rank)
        self.profiler = Profiler(cfg.profile_dir if self.rank == 0 else None)

        self.say("Training model named:\n  ", cfg.model_name)
        self.say("Models and logs are saved to:\n  ", cfg.log_dir)
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        self.say("Training is using:\n  ", f"{self.device} ({name})")
        self.say(f"There are {len(train_ds)} training items and "
                 f"{len(val_ds)} validation items\n")

        self._save_opts()
        self.ckpt_dir = os.path.join(self.log_path, "models", "checkpoints")
        self._saved_step = None
        self.epoch = 0
        self.step = 0

    def say(self, *args):
        """print, on rank 0 only."""
        if self.rank == 0:
            print(*args)

    # ------------------------------------------------------------------
    def _init_encoders(self):
        """weights_init "pretrained": the torchvision ImageNet ResNet into
        the depth encoder and, when the run has one, the pose encoder
        (conv1 averaged over its stacked frames); "scratch" keeps the
        seeded random init."""
        cfg = self.cfg
        if cfg.weights_init != "pretrained":
            self.say(f"weights_init={cfg.weights_init}: random encoder init")
            return
        path = ck.locate_imagenet_weights(cfg.num_layers,
                                          cfg.imagenet_weights)
        ck.load_into(self.bundle.encoder, ck.import_torchvision_resnet(path))
        loaded = ["encoder"]
        if self.bundle.pose_encoder is not None:
            ck.load_into(self.bundle.pose_encoder,
                         ck.import_torchvision_resnet(path,
                                                      cfg.num_pose_frames))
            loaded.append("pose_encoder")
        self.say(f"weights_init=pretrained: ImageNet resnet{cfg.num_layers} "
                 f"from {path} -> {', '.join(loaded)}")

    def _load_initial_weights(self):
        folder = self.cfg.load_weights_folder
        if folder is None:
            return
        kind = ck.load_weights(self.bundle, folder, self.state,
                               self.cfg.models_to_load)
        if kind == "checkpoint":
            self.say(f"restored checkpoint from {folder} "
                     f"(step {self.state.step})")

    def _load_generator(self):
        """The GAN prior's generator from ``generator_weights``, after any
        restore (as the reference trainer); without the file it keeps its
        seeded random weights."""
        cfg = self.cfg
        if not cfg.pre_trained_generator:
            return
        if cfg.generator_weights:
            ck.load_generator(self.bundle, cfg.generator_weights)
            self.say(f"GAN prior: generator from {cfg.generator_weights}")
        else:
            self.say("GAN prior: no --generator_weights; the generator "
                     "keeps its seeded random weights unless a checkpoint "
                     "set them")

    def _save_opts(self):
        if self.rank != 0:
            return
        models_dir = os.path.join(self.log_path, "models")
        os.makedirs(models_dir, exist_ok=True)
        with open(os.path.join(models_dir, "opt.json"), "w") as f:
            f.write(self.cfg.to_json())

    # ------------------------------------------------------------------
    def train(self):
        cfg = self.cfg
        start_step = self.state.step
        self.step = start_step
        spe = max(self.steps_per_epoch, 1)
        start_epoch = start_step // spe
        try:
            with deterministic_cudnn():
                for self.epoch in range(start_epoch, cfg.num_epochs):
                    # mid-epoch resume: the checkpointed step places the
                    # run, and the Loader replays the rest of the epoch
                    start_batch = start_step - self.epoch * spe \
                        if self.epoch == start_epoch else 0
                    self.run_epoch(start_batch)
                    if (self.epoch + 1) % cfg.save_frequency == 0:
                        self.save()
        finally:
            self.close()
        return self.state

    def save(self):
        """Checkpoint the current step (once: an epoch's end may fall on a
        step that ckpt_frequency already saved); every rank calls it."""
        if self._saved_step != self.state.step:
            ck.save_checkpoint(self.ckpt_dir, self.bundle, self.state,
                               self.cfg)
            self._saved_step = self.state.step

    def close(self):
        """End the loaders' workers and close the logs."""
        self.val_iter.close()
        self.train_loader.close()
        self.val_loader.close()
        self.logger.finish()

    def run_epoch(self, start_batch: int = 0):
        cfg = self.cfg
        self.say("Training")
        for batch_idx, batch in enumerate(
                self.train_loader.epoch(self.epoch, start_batch=start_batch),
                start=start_batch):
            if batch_idx >= self.steps_per_epoch:
                break
            t0 = time.time()
            self.profiler.maybe_start(self.step)
            losses = self.train_step(self.state, batch)
            if self.disc_step is not None:
                # one discriminator update per batch, after the step
                losses = {**losses, **self.disc_step(self.state, batch)}

            if batch_idx % cfg.log_frequency == 0:
                loss = float(losses["loss"])  # syncs only when logging
                duration = time.time() - t0
                self.logger.log_time(self.epoch, batch_idx, self.step + 1,
                                     duration, cfg.batch_size, loss)
                self.logger.log_scalars(
                    "train", {k: float(v) for k, v in losses.items()},
                    self.step,
                    learning_rate=float(self.state.schedule(self.step)))
                self.val()
            self.profiler.maybe_stop(self.step)
            self.step += 1
            if cfg.ckpt_frequency and self.step % cfg.ckpt_frequency == 0:
                self.save()

    def val(self):
        """One validation batch, with the depth metrics when the dataset
        ships ground truth; over a mesh every rank runs its rows, and the
        losses and metrics are the global batch's."""
        batch = dict(next(self.val_iter))
        depth_gt = batch.pop("depth_gt", None)
        # a generator of the step: validation never draws from the
        # training stream, so a resumed run matches an uninterrupted one
        gen = noise_generator(self.cfg.seed + 2, self.step, self.device)
        with full_params(self.state):
            losses, outputs = self.eval_step(batch, generator=gen)
        scalars = {k: float(v) for k, v in losses.items()}
        if depth_gt is not None:
            from ..eval.metrics import train_time_depth_metrics

            _, depth = disp_to_depth(outputs["disp"][0][..., 0],
                                     self.cfg.min_depth, self.cfg.max_depth)
            if self.mesh.size > 1:
                # the whole batch's metrics (median scaling over all rows)
                group = self.mesh.group
                depth = torch.cat(all_gather(depth, group))
                depth_gt = torch.cat(all_gather(depth_gt, group))
            scalars.update(train_time_depth_metrics(
                depth.cpu().numpy(), depth_gt.cpu().numpy()))
        self.logger.log_scalars("val", scalars, self.step)
        if self.cfg.log_images:
            images = {f"disp/{s}": outputs["disp"][s][0, ..., 0].cpu().numpy()
                      for s in self.cfg.scales}
            for key, val in outputs.items():
                if key.startswith(("automask/", "color_pred/")):
                    images[key] = np.asarray(val[0].cpu())
            self.logger.log_images("val", images, self.step)
