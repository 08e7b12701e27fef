"""Pose evaluation entry point:

    python -m unsupervised_pose_estimation_tpu_torch.cli.evaluate_pose \
        --load_weights_folder DIR --eval_split SPLIT [flags]

Port of ``unsupervised_pose_estimation_tpu/cli/evaluate_pose.py``: the
reference package's flags (``config.parse_options``). It evaluates on the
CUDA device; ``main(argv, device="cpu")`` evaluates on the CPU.
"""

from __future__ import annotations

from ..config import parse_options
from ..eval.evaluate_pose import evaluate


def main(argv=None, device="cuda"):
    """Evaluate as ``argv`` says; -> the ATE / RE row."""
    opt = parse_options(argv, description="monodepth pose evaluation "
                                          "(PyTorch)")
    return evaluate(opt, device=device)


if __name__ == "__main__":
    main()
