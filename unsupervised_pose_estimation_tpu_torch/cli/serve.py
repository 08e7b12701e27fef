"""Depth inference server:

    python -m unsupervised_pose_estimation_tpu_torch.cli.serve \
        --load_weights_folder <ckpt> --height 192 --width 640 \
        --port 8000 [--max_batch 8] [--max_delay_ms 5]

POST an image to /predict, get the float32 disparity back as .npy bytes:
    curl -s -X POST --data-binary @img.png localhost:8000/predict > disp.npy

Port of ``unsupervised_pose_estimation_tpu/cli/serve.py``, with the same
flags. It serves from the CUDA device; ``main(argv, device="cpu")`` from
the CPU.
"""

from __future__ import annotations

import argparse

from ..config import parse_options
from ..serve import InferenceEngine, MicroBatcher, make_http_server


def main(argv=None, device="cuda"):
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--port", type=int, default=8000)
    extra.add_argument("--host", default="127.0.0.1")
    extra.add_argument("--max_batch", type=int, default=8)
    extra.add_argument("--max_delay_ms", type=float, default=5.0)
    ns, rest = extra.parse_known_args(argv)
    opt = parse_options(rest, description="Depth inference server")

    engine = InferenceEngine(opt, max_batch=ns.max_batch, device=device)
    batcher = MicroBatcher(engine, max_delay_ms=ns.max_delay_ms)
    try:
        server = make_http_server(batcher, host=ns.host, port=ns.port)
        print(f"serving depth inference on http://{ns.host}:"
              f"{server.server_address[1]} (feed {opt.height}x{opt.width}, "
              f"max_batch {ns.max_batch})", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    finally:
        batcher.close()


if __name__ == "__main__":
    main()
