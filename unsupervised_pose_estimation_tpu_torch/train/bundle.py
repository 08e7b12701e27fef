"""Model bundle: the networks of one run, with seeded weights.

Port of ``unsupervised_pose_estimation_tpu/train/bundle.py`` for the
configuration ported so far, for training and evaluation: ResNet depth
encoder, fork depth decoder, and a separate ResNet pose encoder over stacked
frame pairs with its pose decoder, in float32. Unlike the reference, parameters and BatchNorm statistics live in
the modules; ``state_dict()`` keys are ``encoder.*``, ``depth.*``,
``pose_encoder.*`` and ``pose.*`` in the reference ``.pth`` layout
(``convert.from_jax`` maps the reference package's trees onto them).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Options
from ..models import DepthDecoder, PoseDecoder, ResnetEncoder
from ..models.layers import init_weights


def check_supported(cfg: Options) -> None:
    """Raise NotImplementedError for options the port does not run yet."""
    unsupported = {
        "compute_dtype != 'float32'": cfg.compute_dtype != "float32",
        "pose_model_type != 'separate_resnet'":
            cfg.pose_model_type != "separate_resnet",
        "pose_model_input != 'pairs'": cfg.pose_model_input != "pairs",
        "depth_decoder_variant != 'fork'": cfg.depth_decoder_variant != "fork",
        "use_stereo": cfg.use_stereo,
        "v1_multiscale": cfg.v1_multiscale,
        "predictive_mask": cfg.predictive_mask,
        "pre_trained_generator": cfg.pre_trained_generator,
        "adversarial_prior": cfg.adversarial_prior,
    }
    hit = [name for name, on in unsupported.items() if on]
    if hit:
        raise NotImplementedError(f"not ported yet: {', '.join(hit)}")


class ModelBundle(nn.Module):
    """encoder + depth decoder + pose encoder + pose decoder. ``create``
    returns it in eval mode; ``train.step.forward_and_loss`` sets train mode
    (BatchNorm on batch statistics) or eval mode as its ``train`` says."""

    def __init__(self, cfg: Options):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.encoder = ResnetEncoder(cfg.num_layers)
        self.depth = DepthDecoder(self.encoder.num_ch_enc, tuple(cfg.scales))
        self.pose_encoder = ResnetEncoder(cfg.num_layers,
                                          num_input_images=cfg.num_pose_frames)
        self.pose = PoseDecoder(self.pose_encoder.num_ch_enc[-1],
                                num_input_features=1,
                                num_frames_to_predict_for=2)

    @classmethod
    def create(cls, cfg: Options, seed: int = 0,
               device="cuda") -> "ModelBundle":
        """Build on ``device`` with weights drawn from a generator seeded
        with ``seed`` (the global RNG is not touched)."""
        with torch.device("meta"):
            bundle = cls(cfg)
        bundle = bundle.to_empty(device="cpu")
        gen = torch.Generator().manual_seed(seed)
        for name in ("encoder", "pose_encoder"):
            init_weights(getattr(bundle, name), gen, fan_out_convs=True)
        for name in ("depth", "pose"):
            init_weights(getattr(bundle, name), gen)
        return bundle.to(device).eval()
