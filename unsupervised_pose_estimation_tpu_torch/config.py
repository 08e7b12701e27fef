"""Run configuration: the reference package's ``Options`` dataclass.

Same field names and defaults as ``unsupervised_pose_estimation_tpu/
config.py::Options``, so a config written by either package loads in the
other (``to_json`` / ``from_json``), and the same command line
(``parse_options``, ``PRESETS``) gives the same options. The TPU knobs
``pallas_*_interpret`` are accepted and ignored; ``mesh_*`` lay out the
(dcn, data, fsdp) mesh over the processes of a ``torchrun`` launch
(``parallel.mesh``). The kernel switches route as in the
reference: ``use_pallas_warp_loss`` picks the fused warp + loss kernels
(K1/K2) over the warp and loss kernels (K5, K3/K4), ``pallas_warp_version``
the warp's kernel ladder, and ``use_pallas_warp=False`` /
``use_pallas_loss=False`` send the warps / the losses to their plain
PyTorch versions, either one turning the fused op off. Otherwise the port
runs its CUDA kernels on a CUDA device and their plain PyTorch versions on
the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class Options:
    # paths
    data_path: str = "data"
    log_dir: str = "logs"
    tra_path: str = "data"

    # training
    pre_trained_generator: bool = False
    generator_weights: Optional[str] = None
    model_name: str = "mdp"
    split: str = "endovis"
    split_dir: Optional[str] = None
    num_layers: int = 18
    dataset: str = "endovis"
    png: bool = False
    height: int = 192
    width: int = 192
    disparity_smoothness: float = 1e-4
    position_smoothness: float = 1e-3
    consistency_constraint: float = 0.01
    epipolar_constraint: float = 0.01
    geometry_constraint: float = 0.01
    transform_constraint: float = 0.01
    transform_smoothness: float = 0.01
    scales: Tuple[int, ...] = (0, 1, 2, 3)
    min_depth: float = 0.1
    max_depth: float = 150.0
    use_stereo: bool = False
    frame_ids: Tuple[int, ...] = (0, -1, 1)
    eval_pose_trajectory: bool = True

    # optimization
    batch_size: int = 16
    learning_rate: float = 1e-4
    num_epochs: int = 10
    scheduler_step_size: int = 10

    # ablations
    v1_multiscale: bool = False
    avg_reprojection: bool = False
    disable_automasking: bool = False
    predictive_mask: bool = False
    no_ssim: bool = False
    weights_init: str = "pretrained"
    pose_model_input: str = "pairs"
    pose_model_type: str = "separate_resnet"

    # system
    no_cuda: bool = False
    num_workers: int = 12
    num_worker_procs: int = 0

    # loading
    load_weights_folder: Optional[str] = None
    models_to_load: Tuple[str, ...] = ("pose_encoder", "pose", "depth",
                                       "encoder")

    # logging
    sampling_frequency: int = 1
    log_frequency: int = 100
    save_frequency: int = 1
    ckpt_frequency: int = 0

    # evaluation
    eval_stereo: bool = False
    eval_mono: bool = False
    wandb_sweep: bool = False
    disable_median_scaling: bool = False
    pred_depth_scale_factor: float = 1.0
    ext_disp_to_eval: Optional[str] = None
    eval_split: str = "endovis"
    save_pred_disps: bool = False
    no_eval: bool = False
    eval_eigen_to_benchmark: bool = False
    adversarial_prior: bool = False
    discriminator_lr: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    eval_out_dir: Optional[str] = None
    post_process: bool = False

    # additions of the reference package
    imagenet_weights: Optional[str] = None
    lr_scheduler: str = "none"
    depth_decoder_variant: str = "fork"
    compute_dtype: str = "bfloat16"  # the networks' dtype: "bfloat16" or
    # "float32" (TF32 off on the card); parameters stay float32
    mesh_data: int = -1  # data-parallel processes; -1: the world's
    # processes over fsdp x dcn
    mesh_fsdp: int = 1   # processes sharing one copy of the parameters
    # and Adam moments (each keeps 1/fsdp); the batch is split over it too
    mesh_dcn: int = 1    # the axis between nodes: 1 or the number of nodes
    grad_accum: int = 1
    prefetch: int = 2
    device_augment: bool = True
    frame_cache: Optional[str] = None
    seed: int = 0
    log_jsonl: bool = True
    profile_dir: Optional[str] = None
    synthetic_data: bool = False
    synthetic_rotation: bool = False
    debug_nans: bool = False
    use_pallas_loss: bool = True   # the loss kernels K3/K4 (and K1/K2);
    # off: the plain SSIM + L1 and no fused op
    pallas_loss_interpret: bool = False  # ignored
    use_pallas_warp: bool = True   # the warp kernels (and K1/K2); off: the
    # plain bilinear sample and no fused op
    pallas_warp_interpret: bool = False  # ignored
    pallas_warp_version: int = 8  # top rung of the warp ladder: 8 (and
    # above) K5, with K1/K2 when use_pallas_warp_loss; 1-5 the per-plane
    # corner fetch K6 (v2: per-row minibands), 6 the channel-packed K7, 7
    # the miniband K8 (6 and 7 for uint8 frames only), each with the K6
    # rungs and a plain gather beneath it and the loss in K3/K4
    use_pallas_warp_loss: bool = True   # fused K1 + K2, else K5 + K3/K4
    log_images: bool = False
    steps_per_epoch: Optional[int] = None
    wandb: bool = False

    @property
    def num_scales(self) -> int:
        return len(self.scales)

    @property
    def num_input_frames(self) -> int:
        return len(self.frame_ids)

    @property
    def num_pose_frames(self) -> int:
        return 2 if self.pose_model_input == "pairs" else self.num_input_frames

    @property
    def use_pose_net(self) -> bool:
        return not (self.use_stereo and tuple(self.frame_ids) == (0,))

    @property
    def source_frame_ids(self) -> Tuple:
        ids = [f for f in self.frame_ids if f != 0]
        if self.use_stereo:
            ids = ids + ["s"]
        return tuple(ids)

    def validate(self):
        """Raise ValueError for an inconsistent set of options; -> self."""
        checks = [
            (self.height % 32 == 0, "'height' must be a multiple of 32"),
            (self.width % 32 == 0, "'width' must be a multiple of 32"),
            (self.frame_ids[0] == 0, "frame_ids must start with 0"),
            (not self.predictive_mask or self.disable_automasking,
             "When using predictive_mask, please disable automasking with "
             "--disable_automasking"),
            (not self.adversarial_prior or self.pre_trained_generator,
             "--adversarial_prior requires --pre_trained_generator"),
            (self.grad_accum >= 1 and self.batch_size % self.grad_accum == 0,
             "batch_size must be divisible by grad_accum"),
        ]
        for ok, message in checks:
            if not ok:
                raise ValueError(message)
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_json(cls, text: str) -> "Options":
        raw = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in known}
        for key in ("scales", "frame_ids", "models_to_load"):
            if kwargs.get(key) is not None:
                kwargs[key] = tuple(kwargs[key])
        return cls(**kwargs)


# Canonical configurations: "endovis" is the fork's default flag set,
# "kitti_upstream" the original monodepth2 defaults (640x192, depth
# [0.1, 100], batch 12, lr 1e-4, 20 epochs, eigen_zhou).
PRESETS = {
    "endovis": {},
    "kitti_upstream": dict(dataset="kitti", split="eigen_zhou", height=192,
                           width=640, min_depth=0.1, max_depth=100.0,
                           batch_size=12, learning_rate=1e-4, num_epochs=20,
                           scheduler_step_size=15, lr_scheduler="step",
                           eval_split="eigen"),
}


def _add_args(parser: argparse.ArgumentParser):
    for field in dataclasses.fields(Options):
        name = "--" + field.name
        default = field.default
        if isinstance(default, bool):
            if default:  # flags that are on by default switch off
                parser.add_argument(name, dest=field.name,
                                    action="store_false")
            else:
                parser.add_argument(name, action="store_true")
        elif isinstance(default, tuple):
            elem = int if (not default or isinstance(default[0], int)) else str
            parser.add_argument(name, nargs="+", type=elem,
                                default=list(default))
        elif default is None:
            elem = int if "int" in str(field.type) else str
            parser.add_argument(name, type=elem, default=None)
        elif isinstance(default, int):
            parser.add_argument(name, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def parse_options(argv: Optional[Sequence[str]] = None,
                  description: str = "Monodepth options") -> Options:
    """argv -> Options. ``--preset NAME`` starts from ``PRESETS[NAME]``;
    flags given explicitly override the preset."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--preset", choices=sorted(PRESETS), default=None,
                        help="start from a canonical config; explicit flags "
                             "override preset values")
    _add_args(parser)
    # a second pass with suppressed defaults tells which flags were given
    explicit_parser = argparse.ArgumentParser(add_help=False)
    explicit_parser.add_argument("--preset")
    _add_args(explicit_parser)
    for action in explicit_parser._actions:
        action.default = argparse.SUPPRESS

    kwargs = vars(parser.parse_args(argv))
    explicit = vars(explicit_parser.parse_known_args(argv)[0])
    preset = kwargs.pop("preset", None)
    if preset:
        for key, value in PRESETS[preset].items():
            if key not in explicit:
                kwargs[key] = value
    for key in ("scales", "frame_ids", "models_to_load"):
        kwargs[key] = tuple(kwargs[key])
    return Options(**kwargs)


# the reference's class names (its options module and the evaluation
# options it imports)
MonodepthOptions = Options
MonodepthEvalOptions = Options
