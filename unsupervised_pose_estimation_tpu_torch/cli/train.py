"""Training entry point:

    python -m unsupervised_pose_estimation_tpu_torch.cli.train [flags]

Port of ``unsupervised_pose_estimation_tpu/cli/train.py``: the reference
package's flags (``config.parse_options``), and with ``--wandb_sweep`` ten
runs of a random search over the learning rate and the sampling frequency.
It trains on the CUDA device; ``main(argv, device="cpu")`` trains on the
CPU.
"""

from __future__ import annotations

import numpy as np

from ..config import parse_options
from ..train.loop import Trainer


def main(argv=None, device="cuda") -> Trainer:
    """Train as ``argv`` says; -> the (last) Trainer, after its run."""
    opts = parse_options(argv, description="monodepth training (PyTorch)")
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
