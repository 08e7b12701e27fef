"""Training entry point:

    python -m unsupervised_pose_estimation_tpu_torch.cli.train [flags]

Port of ``unsupervised_pose_estimation_tpu/cli/train.py``: the reference
package's flags (``config.parse_options``), and with ``--wandb_sweep`` ten
runs of a random search over the learning rate and the sampling frequency.
It trains on the CUDA device; ``main(argv, device="cpu")`` trains on the
CPU.

Under ``torchrun`` (``WORLD_SIZE`` in the environment) it joins the
default process group first, NCCL on the card (each process on
``cuda:LOCAL_RANK``) and gloo on the CPU, and leaves it at the end; the
``--mesh_*`` flags then lay out the mesh over the processes:

    torchrun --nproc_per_node N -m unsupervised_pose_estimation_tpu_torch.cli.train --mesh_data N ...

A process group that fails to start raises; nothing falls back to another
backend or device.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..config import parse_options
from ..train.loop import Trainer


def init_process_group(device="cuda") -> bool:
    """Join the default process group that torchrun's environment
    describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL for a CUDA ``device``, gloo for the CPU; -> whether
    this call started it (False without ``WORLD_SIZE``, or when a group is
    up already)."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl", init_method="env://")
    else:
        dist.init_process_group("gloo", init_method="env://")
    return True


def main(argv=None, device="cuda") -> Trainer:
    """Train as ``argv`` says; -> the (last) Trainer, after its run."""
    opts = parse_options(argv, description="monodepth training (PyTorch)")
    started = init_process_group(device)
    try:
        return _train(opts, device)
    finally:
        if started:
            dist.destroy_process_group()


def _train(opts, device) -> Trainer:
    if opts.wandb_sweep:
        rng = np.random.default_rng(opts.seed)
        for trial in range(10):
            lr = float(10 ** rng.uniform(-8, -3))
            sampling = int(rng.integers(1, 5))
            print(f"[sweep trial {trial}] lr={lr:g} sampling={sampling}")
            trainer = Trainer(opts, lr=lr, sampling=sampling, device=device)
            trainer.train()
    else:
        trainer = Trainer(opts, device=device)
        trainer.train()
    return trainer


if __name__ == "__main__":
    main()
