"""Export the depth model: checkpoint -> ``torch.export`` artifact.

    python -m unsupervised_pose_estimation_tpu_torch.cli.export_model \
        --load_weights_folder <ckpt> --out model.pt2 [--max_batch 8]

Port of ``unsupervised_pose_estimation_tpu/cli/export_model.py``, with the
same flags. The artifact (with its ``.json`` sidecar of feed metadata)
reloads with ``serve.load_artifact`` and runs without the model code. It
exports on the CUDA device; ``main(argv, device="cpu")`` on the CPU.
"""

from __future__ import annotations

import argparse

from ..config import parse_options
from ..serve import export_artifact


def main(argv=None, device="cuda"):
    """-> the artifact's path."""
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--out", default="model.pt2")
    extra.add_argument("--max_batch", type=int, default=8)
    ns, rest = extra.parse_known_args(argv)
    opt = parse_options(rest, description="Export depth model")
    path = export_artifact(opt, ns.out, max_batch=ns.max_batch,
                           device=device)
    print(f"exported {path} (+ {path}.json)")
    return path


if __name__ == "__main__":
    main()
