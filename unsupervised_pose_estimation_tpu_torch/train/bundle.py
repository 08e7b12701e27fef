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
  reference builds it with no variant).

A module the options do not use is None. Unlike the reference, parameters
and BatchNorm statistics live in the modules; ``state_dict()`` keys are the
module names above over the reference ``.pth`` layout
(``convert.from_jax`` maps the reference package's trees onto them).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import Options
from ..models import DepthDecoder, PoseCNN, PoseDecoder, ResnetEncoder
from ..models.layers import init_weights

POSE_MODEL_TYPES = ("separate_resnet", "shared", "posecnn")


def check_supported(cfg: Options) -> None:
    """Raise NotImplementedError for options the port does not run yet,
    and ValueError for options that cannot run together."""
    unsupported = {
        "pre_trained_generator": cfg.pre_trained_generator,
        "adversarial_prior": cfg.adversarial_prior,
    }
    hit = [name for name, on in unsupported.items() if on]
    if hit:
        raise NotImplementedError(f"not ported yet: {', '.join(hit)}")
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

    @classmethod
    def create(cls, cfg: Options, seed: int = 0,
               device="cuda") -> "ModelBundle":
        """Build on ``device`` with weights drawn from a generator seeded
        with ``seed`` (the global RNG is not touched): the ResNets first,
        then the decoders, each in a fixed order."""
        with torch.device("meta"):
            bundle = cls(cfg)
        bundle = bundle.to_empty(device="cpu")
        gen = torch.Generator().manual_seed(seed)
        for name in ("encoder", "pose_encoder"):
            if getattr(bundle, name) is not None:
                init_weights(getattr(bundle, name), gen, fan_out_convs=True)
        for name in ("depth", "pose", "predictive_mask"):
            if getattr(bundle, name) is not None:
                init_weights(getattr(bundle, name), gen)
        return bundle.to(device).eval()
