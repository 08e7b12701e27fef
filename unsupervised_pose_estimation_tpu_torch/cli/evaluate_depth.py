"""Depth evaluation entry point:

    python -m unsupervised_pose_estimation_tpu_torch.cli.evaluate_depth \
        --load_weights_folder DIR --eval_mono [flags]

Port of ``unsupervised_pose_estimation_tpu/cli/evaluate_depth.py``: the
reference package's flags (``config.parse_options``). It evaluates on the
CUDA device; ``main(argv, device="cpu")`` evaluates on the CPU.
"""

from __future__ import annotations

from ..config import parse_options
from ..eval.evaluate_depth import evaluate


def main(argv=None, device="cuda"):
    """Evaluate as ``argv`` says; -> the metric row (None without one)."""
    opt = parse_options(argv, description="monodepth depth evaluation "
                                          "(PyTorch)")
    return evaluate(opt, device=device)


if __name__ == "__main__":
    main()
