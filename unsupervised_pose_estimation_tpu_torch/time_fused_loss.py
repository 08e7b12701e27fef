"""Device time of the fused warp + SSIM/L1 pair (K1 forward, K2 backward),
warm and with a cold L2, and the peak device memory of the fused training
step, at the main path's shapes on a CUDA card.

    python3 unsupervised_pose_estimation_tpu_torch/time_fused_loss.py \
        [--tree DIR]

``--tree`` times the package of another checkout (default: the one this
file is in), for example the parent commit unpacked with ``git archive``.
To compare two trees, run both in one chip call, in turns (parent, change,
change, parent). A tree whose K1 still has the residual mode, whose K2 then
reads K1's warped / ddx / ddy planes, is timed in that mode as well, since
its training step ran K1 so. Inputs are ``chip_smoke.py`` phase 2's (seed 0,
small-motion grid, B=12, C=3, 192x640); the training step is phase 5's
(batch 12, 640x192, seed-0 weights, three fused steps after a reset of the
peak-memory count). Timing and bounds are ``chip_smoke.py``'s ``cuda_ms``
(warm: 20 launches back to back after 3 warm-ups) and ``cuda_ms_cold``
(the L2 flushed before each launch). Prints the card's name and power
limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=str(ROOT),
                        help="root of the checkout whose package is timed")
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    # run as a file: put the tree's root, not this package's directory,
    # first on the import path
    sys.path[0] = str(tree)
    import torch

    if not torch.cuda.is_available():
        print("time_fused_loss: no CUDA device", file=sys.stderr)
        return 2
    smoke = _chip_smoke()
    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.ops.kernels import _lib
    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle
    from unsupervised_pose_estimation_tpu_torch.train.state import \
        create_train_state
    from unsupervised_pose_estimation_tpu_torch.train.step import \
        build_train_step

    if tree not in Path(K.__file__).resolve().parents:
        raise RuntimeError(f"imported {K.__file__}, not the package of "
                           f"{tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _lib.library()
    if _lib.build_log:
        print(_lib.build_log.strip(), flush=True)

    gen = torch.Generator().manual_seed(0)
    src, target, small, _ = smoke.make_inputs(gen, "cuda")
    g_up = torch.rand((smoke.B, smoke.H, smoke.W), generator=gen).to("cuda")
    records = {}

    def record(name, fn, nbytes):
        records[name] = dict(
            warm_ms=smoke.cuda_ms(fn), cold_ms=smoke.cuda_ms_cold(fn),
            mb=nbytes / 1e6, bound_ms=nbytes / smoke.HBM_BYTES_PER_S * 1e3)

    loss = K.warp_reproj_loss(src, small, target)
    record("k1", lambda: K.warp_reproj_loss(src, small, target),
           smoke.nbytes(src, small, target, loss))
    if "residuals" in inspect.signature(K.warp_reproj_loss).parameters:
        out = K.warp_reproj_loss(src, small, target, True)
        record("k1_residuals",
               lambda: K.warp_reproj_loss(src, small, target, True),
               smoke.nbytes(src, small, target, *out))
        bwd_args = (out[1], target, out[2], out[3], g_up)
        train_k1 = "k1_residuals"
    else:
        bwd_args = (src, small, target, g_up)
        train_k1 = "k1"
    grads = K.warp_reproj_loss_bwd(*bwd_args)
    record("k2", lambda: K.warp_reproj_loss_bwd(*bwd_args),
           smoke.nbytes(*bwd_args, *grads))
    del src, target, small, g_up, loss, bwd_args, grads
    pair = {t: records[train_k1][t] + records["k2"][t]
            for t in ("warm_ms", "cold_ms")}

    bundle = ModelBundle.create(smoke.smoke_options(), seed=0, device="cuda")
    bundle.cfg.use_pallas_warp_loss = True
    state = create_train_state(bundle)
    step = build_train_step(bundle)
    batch = smoke.train_batch(torch.Generator().manual_seed(6), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(3):
        start = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - start))
    print(json.dumps({
        "tree": str(tree), "device": torch.cuda.get_device_name(0),
        "kernels": records, "train_k1": train_k1,
        "pair_per_call_ms": pair,
        "pair_per_step_ms": {t: 8 * v for t, v in pair.items()},
        "fused_step_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "fused_step_wall_ms": step_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
