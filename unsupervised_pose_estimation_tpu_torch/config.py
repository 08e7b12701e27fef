"""Run configuration: the reference package's ``Options`` dataclass.

Same field names and defaults as ``unsupervised_pose_estimation_tpu/
config.py::Options``, so a config written by either package loads in the
other (``to_json`` / ``from_json``). The TPU knobs (``use_pallas_*``,
``pallas_*``, ``mesh_*``) are accepted and ignored, except
``use_pallas_warp_loss``, which picks the fused warp + loss kernels (K1/K2)
over the warp and loss kernels (K5, K3/K4) as in the reference, and
``pallas_warp_version``, which picks the warp's kernel ladder as in the
reference. The port always runs its CUDA kernels on a CUDA device and
their plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


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
    compute_dtype: str = "bfloat16"  # the port runs "float32" only so far
    mesh_data: int = -1        # ignored
    mesh_fsdp: int = 1         # ignored
    mesh_dcn: int = 1          # ignored
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
    use_pallas_loss: bool = True        # ignored
    pallas_loss_interpret: bool = False  # ignored
    use_pallas_warp: bool = True        # ignored
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
    def num_pose_frames(self) -> int:
        return 2 if self.pose_model_input == "pairs" else len(self.frame_ids)

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
