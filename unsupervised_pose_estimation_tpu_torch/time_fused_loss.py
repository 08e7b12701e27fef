"""Device time of the SSIM/L1 kernels, warm and with a cold L2: the fused
warp + loss pair (K1 forward, K2 backward) and the loss of a warped plane
(K3 forward, K4 backward); of the channel-packed corner fetches (K7 at
``pallas_warp_version`` 6, K8 at 7); and the peak device memory and wall
time of the training step in both warp + loss modes; at the main path's
shapes on a CUDA card.

    python3 unsupervised_pose_estimation_tpu_torch/time_fused_loss.py \
        [--tree DIR]

``--tree`` times the package of another checkout (default: the one this
file is in), for example the parent commit unpacked with ``git archive``.
To compare two trees, run both in one chip call, in turns (parent, change,
change, parent). A tree whose K1 still has the residual mode, whose K2 then
reads K1's warped / ddx / ddy planes, is timed in that mode as well, since
its training step ran K1 so. K4 is timed with both gradients (``k4``) and,
in a tree whose K4 takes ``with_target``, without the target's
(``k4_gp_only``), the training step's mode. Inputs are ``chip_smoke.py``
phase 2's (seed 0, small-motion grid, B=12, C=3, 192x640; K3 and K4 score
K5's warp of the frame against the target); records ``k7`` and ``k8`` take
phase 6's (seed 10, small-motion grid, the indices of the v6 and v7
rungs), and ``copy_same_bytes`` times a device-to-device copy that
moves as many bytes as K7 does (half read, half written), the rate a plain
stream of bytes reaches; the training step is phase 5's
(batch 12, 640x192, seed-0 weights; three fused steps, then three unfused
ones, each mode after a reset of the peak-memory count). Per step, the
fused mode runs K1 and K2 eight times each (and K3 twice), the unfused
mode K3 ten times and K4 eight. Timing and bounds are ``chip_smoke.py``'s ``cuda_ms``
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
    warped = K.warp(src, small)[0]
    loss = K.reproj_loss(warped, target)
    record("k3", lambda: K.reproj_loss(warped, target),
           smoke.nbytes(warped, target, loss))
    grads = K.reproj_loss_bwd(warped, target, g_up)
    record("k4", lambda: K.reproj_loss_bwd(warped, target, g_up),
           smoke.nbytes(warped, target, g_up, *grads))
    if "with_target" in inspect.signature(K.reproj_loss_bwd).parameters:
        gp = K.reproj_loss_bwd(warped, target, g_up, with_target=False)[0]
        record("k4_gp_only", lambda: K.reproj_loss_bwd(
            warped, target, g_up, with_target=False),
            smoke.nbytes(warped, target, g_up, gp))
        del gp
    del src, target, small, g_up, loss, bwd_args, grads, warped

    # K7 and K8 on phase 6's inputs (seed 10, small-motion grid)
    src, _, small, _ = smoke.make_inputs(torch.Generator().manual_seed(10),
                                         "cuda")
    for name, version, rung, fetch in (
            ("k7", 6, "v6", K.fetch_corners_packed),
            ("k8", 7, "v7", K.fetch_corners_packed_v7)):
        x0i, yl, ymin, band = smoke.rung_inputs(small, version, rung)
        args = (src, x0i, yl, ymin) + ((band,) if version == 6 else ())
        record(name, lambda: fetch(*args),
               smoke.nbytes(src, x0i, yl, ymin, *fetch(*args)))
    # yardstick: a device-to-device copy that moves as many bytes as K7
    moved = records["k7"]["mb"] * 1e6
    a = torch.empty(int(moved / 2), dtype=torch.uint8, device="cuda")
    c = torch.empty_like(a)
    record("copy_same_bytes", lambda: c.copy_(a), 2 * a.numel())
    del src, small, x0i, yl, ymin, args, a, c
    pair = {t: records[train_k1][t] + records["k2"][t]
            for t in ("warm_ms", "cold_ms")}

    train_k4 = "k4_gp_only" if "k4_gp_only" in records else "k4"
    loss_pair = {t: 10 * records["k3"][t] + 8 * records[train_k4][t]
                 for t in ("warm_ms", "cold_ms")}

    bundle = ModelBundle.create(smoke.smoke_options(), seed=0, device="cuda")
    state = create_train_state(bundle)
    step = build_train_step(bundle)
    batch = smoke.train_batch(torch.Generator().manual_seed(6), "cuda")
    steps = {}
    for mode, fused in (("fused", True), ("unfused", False)):
        bundle.cfg.use_pallas_warp_loss = fused
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for _ in range(3):
            start = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - start))
        steps[f"{mode}_step_peak_gib"] = (torch.cuda.max_memory_allocated()
                                          / 2**30)
        steps[f"{mode}_step_wall_ms"] = step_ms
    print(json.dumps({
        "tree": str(tree), "device": torch.cuda.get_device_name(0),
        "kernels": records, "train_k1": train_k1,
        "pair_per_call_ms": pair,
        "pair_per_step_ms": {t: 8 * v for t, v in pair.items()},
        "train_k4": train_k4,
        "k3_k4_per_unfused_step_ms": loss_pair, **steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
