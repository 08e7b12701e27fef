"""Model bundle: the networks of one run, with seeded weights.

Port of ``unsupervised_pose_estimation_tpu/train/bundle.py``, for training
and evaluation, computing at ``cfg.compute_dtype`` (bfloat16 or float32)
with float32 parameters, disparities and poses:

- ``encoder``: the ResNet depth encoder;
- ``depth``: the depth decoder of ``cfg.depth_decoder_variant``;
- the pose network, when ``cfg.use_pose_net``, by ``cfg.pose_model_type``:
  ``separate_resnet``, a ResNet ``pose_encoder`` over the stacked pose
  frames and a ``pose`` decoder; ``shared``, a ``pose`` decoder over the
  depth encoder's features of each pose frame; ``posecnn``, a ``PoseCNN``
  ``pose`` over the stacked frames (all of them under
  ``pose_model_input="all"``, else a pair);
- ``predictive_mask``, with ``cfg.predictive_mask``: a fork decoder with one
  output per source frame, whatever ``depth_decoder_variant`` says (the
  reference builds it with no variant);
- ``generator``, with ``cfg.pre_trained_generator``: the GAN prior's frozen
  CycleGAN ``GeneratorResNet`` (one channel, 9 residual blocks), whose
  parameters do not require gradients;
- ``discriminator``, with ``cfg.adversarial_prior``: the
  ``PatchGANDiscriminator``, which its own Adam trains
  (``train.step.build_disc_step``).

A module the options do not use is None. ``main_parameters()`` are the
parameters the training step's Adam updates: every network's but the
generator's and the discriminator's. Unlike the reference, parameters
and BatchNorm statistics live in the modules; ``state_dict()`` keys are the
module names above over the reference ``.pth`` layout
(``convert.from_jax`` maps the reference package's trees onto them).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import Options
from ..models import (DepthDecoder, GeneratorResNet, PatchGANDiscriminator,
                      PoseCNN, PoseDecoder, ResnetEncoder)
from ..models.layers import init_weights

POSE_MODEL_TYPES = ("separate_resnet", "shared", "posecnn")
# the networks that the training step's Adam does not update
GAN_MODULES = ("generator", "discriminator")


def check_supported(cfg: Options) -> None:
    """Raise ValueError for options that cannot run together."""
    if cfg.adversarial_prior and not cfg.pre_trained_generator:
        raise ValueError("adversarial_prior requires pre_trained_generator: "
                         "the discriminator's real samples are the "
                         "generator's")
    if cfg.pre_trained_generator and cfg.v1_multiscale and \
            any(s > 0 for s in cfg.scales):
        # the prior is full size, and v1 multiscale compares it with each
        # scale's own disparity: the reference's silog_loss fails to
        # broadcast in the first step
        raise ValueError("pre_trained_generator and v1_multiscale cannot be "
                         "combined: the prior is full size and the "
                         "disparities of scales above 0 are not")
    if cfg.pose_model_type not in POSE_MODEL_TYPES:
        raise ValueError(f"pose_model_type must be one of "
                         f"{POSE_MODEL_TYPES}, got {cfg.pose_model_type!r}")
    if cfg.use_stereo and cfg.predictive_mask:
        # the mask has one channel per temporal source (len(frame_ids) - 1),
        # the reprojection losses one more for the stereo frame: the
        # reference's product fails to broadcast in the first step
        raise ValueError("use_stereo and predictive_mask cannot be combined: "
                         "the mask has no channel for the stereo frame")


def compute_dtype(cfg: Options) -> Optional[torch.dtype]:
    """The networks' dtype: bfloat16, or None for float32 (the modules then
    cast nothing)."""
    if cfg.compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', "
                         f"got {cfg.compute_dtype!r}")
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


class ModelBundle(nn.Module):
    """The run's networks (module docstring). ``create`` returns it in eval
    mode; ``train.step.forward_and_loss`` sets train mode (BatchNorm on
    batch statistics) or eval mode as its ``train`` says."""

    def __init__(self, cfg: Options):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dt = compute_dtype(cfg)
        self.encoder = ResnetEncoder(cfg.num_layers, compute_dtype=dt)
        self.depth = DepthDecoder(self.encoder.num_ch_enc, tuple(cfg.scales),
                                  compute_dtype=dt,
                                  variant=cfg.depth_decoder_variant)
        self.pose_encoder = self.pose = self.predictive_mask = None
        self.generator = self.discriminator = None
        kind = cfg.pose_model_type
        if cfg.use_pose_net and kind == "separate_resnet":
            self.pose_encoder = ResnetEncoder(
                cfg.num_layers, num_input_images=cfg.num_pose_frames,
                compute_dtype=dt)
            self.pose = PoseDecoder(self.pose_encoder.num_ch_enc[-1],
                                    num_input_features=1,
                                    num_frames_to_predict_for=2,
                                    compute_dtype=dt)
        elif cfg.use_pose_net and kind == "shared":
            self.pose = PoseDecoder(
                self.encoder.num_ch_enc[-1],
                num_input_features=cfg.num_pose_frames,
                num_frames_to_predict_for=cfg.num_pose_frames - 1,
                compute_dtype=dt)
        elif cfg.use_pose_net and kind == "posecnn":
            self.pose = PoseCNN(cfg.num_pose_frames, compute_dtype=dt)
        if cfg.predictive_mask:
            self.predictive_mask = DepthDecoder(
                self.encoder.num_ch_enc, tuple(cfg.scales),
                num_output_channels=len(cfg.frame_ids) - 1, compute_dtype=dt)
        if cfg.pre_trained_generator:
            self.generator = GeneratorResNet(1, 9, compute_dtype=dt)
            self.generator.requires_grad_(False)
        if cfg.adversarial_prior:
            self.discriminator = PatchGANDiscriminator(compute_dtype=dt)

    def named_main_parameters(self):
        """(name, parameter) of the parameters the training step's Adam
        updates, in registration order: those of every network but
        ``GAN_MODULES``."""
        return [(n, p) for n, p in self.named_parameters()
                if n.split(".", 1)[0] not in GAN_MODULES]

    def main_parameters(self):
        return [p for _, p in self.named_main_parameters()]

    @classmethod
    def create(cls, cfg: Options, seed: int = 0,
               device="cuda") -> "ModelBundle":
        """Build on ``device`` with weights drawn from a generator seeded
        with ``seed`` (the global RNG is not touched): the ResNets first,
        then the decoders, then the GAN prior's generator and
        discriminator, each in a fixed order."""
        with torch.device("meta"):
            bundle = cls(cfg)
        bundle = bundle.to_empty(device="cpu")
        gen = torch.Generator().manual_seed(seed)
        for name in ("encoder", "pose_encoder"):
            if getattr(bundle, name) is not None:
                init_weights(getattr(bundle, name), gen, fan_out_convs=True)
        for name in ("depth", "pose", "predictive_mask", *GAN_MODULES):
            if getattr(bundle, name) is not None:
                init_weights(getattr(bundle, name), gen)
        return bundle.to(device).eval()
