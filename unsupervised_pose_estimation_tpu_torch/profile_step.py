"""Where the time of the validation step, a serving batch and the training
step goes, on a CUDA card.

    python -m unsupervised_pose_estimation_tpu_torch.profile_step
    python -m unsupervised_pose_estimation_tpu_torch.profile_step --train
    python -m unsupervised_pose_estimation_tpu_torch.profile_step --train \
        --warp-version 7
    python -m unsupervised_pose_estimation_tpu_torch.profile_step --train \
        --compute_dtype bfloat16

Without ``--train`` it runs the validation step (both ``with_images``
modes) at batch 12 and the inference step at batch 8; with ``--train``, the
training step (forward, loss, backward, Adam) at batch 12 with the fused
warp + loss kernels and with the unfused ones. ``--warp-version`` 1-7 sets
``pallas_warp_version``: the warps then go through that version's ladder
(one unfused mode), and each record also gives the host time spent in the
ladder's gate reads (``upe::warp_ladder_gates``, one device synchronisation
per warp) and the rungs that ran. ``--compute_dtype`` is the networks'
(float32 by default; TF32 off either way). All at 640x192 with random
weights from a seed. It warms each up, then traces ``STEPS`` calls with
``torch.profiler`` and prints, per call: wall time (host clock around work
that ends in a synchronize), device busy time (the sum of kernel times),
the idle share (1 - busy / wall), the kernels that take the most device
time, and the convolution and matmul operators (with input shapes) that
launched the most. One JSON line per workload, after a line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .config import Options
from .ops import kernels as K
from .train.bundle import ModelBundle
from .train.state import create_train_state
from .train.step import build_eval_step, build_infer_step, build_train_step

B, H, W = 12, 192, 640
SERVE_BATCH = 8
STEPS = 5
TOP = 12


def _batch(gen, device):
    color = torch.randint(0, 256, (B, 3, H, W, 3), generator=gen,
                          dtype=torch.uint8)
    K = torch.tensor([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0],
                      [0, 0, 0, 1]], dtype=torch.float32)
    return {"color": color.to(device), "color_aug": color.to(device),
            "K_norm": K.expand(B, 4, 4).contiguous().to(device)}


OPS = ("aten::conv2d", "aten::conv_transpose2d", "aten::einsum",
       "aten::matmul", "aten::bmm", "aten::convolution_backward")


def _device_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _total_device_us(evt):
    return getattr(evt, "device_time_total",
                   getattr(evt, "cuda_time_total", 0.0))


def trace(name, fn):
    """Warm ``fn`` up, trace STEPS calls, print one JSON record."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    K.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        start = time.perf_counter()
        for _ in range(STEPS):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / STEPS
    rungs = {k: n // STEPS for k, n in K.rung_counts().items() if n}
    averages = prof.key_averages()
    kernels = [e for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    gates = [e for e in averages if e.key == "upe::warp_ladder_gates"
             and e.device_type == torch.autograd.DeviceType.CPU]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / STEPS
    kernels.sort(key=_device_us, reverse=True)
    # the operators behind the kernels: top-level aten ops with their input
    # shapes, by the device time of everything they launched
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key in OPS and _total_device_us(e) > 0]
    ops.sort(key=_total_device_us, reverse=True)
    print(json.dumps({
        "workload": name, "device": torch.cuda.get_device_name(0),
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "gate_reads": sum(e.count for e in gates) // STEPS,
        "gate_read_ms": sum(e.cpu_time_total for e in gates) / 1e3 / STEPS,
        "rungs": rungs,
        "top_kernels": [{"name": e.key[:80], "calls": e.count // STEPS,
                         "ms": _device_us(e) / 1e3 / STEPS}
                        for e in kernels[:TOP]],
        "top_ops": [{"op": e.key, "shapes": str(e.input_shapes)[:120],
                     "calls": e.count // STEPS,
                     "ms": _total_device_us(e) / 1e3 / STEPS}
                    for e in ops[:TOP]]}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--train", action="store_true",
                        help="profile the training step instead")
    parser.add_argument("--warp-version", type=int, default=8,
                        help="pallas_warp_version (1-7: the warp ladder)")
    parser.add_argument("--compute_dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="the networks' dtype")
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = Options(height=H, width=W, batch_size=B,
                  compute_dtype=args.compute_dtype,
                  pallas_warp_version=args.warp_version)
    tag = "" if args.warp_version >= 8 else f"_warp_v{args.warp_version}"
    if args.compute_dtype != "float32":
        tag += f"_{args.compute_dtype}"
    bundle = ModelBundle.create(opt, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(1)
    batch = _batch(gen, "cuda")
    if args.train:
        del batch["color_aug"]
        batch["aug_params"] = torch.tensor(
            [[1.0, 1.1, 0.9, 1.15, 0.05, 1.0]] * B, device="cuda")
        state = create_train_state(bundle)
        step = build_train_step(bundle)
        # below version 8 the loss is never fused: one mode
        for fused in (True, False) if args.warp_version >= 8 else (False,):
            bundle.cfg.use_pallas_warp_loss = fused
            trace(f"train_step_b{B}_fused_{fused}{tag}",
                  lambda: step(state, batch))
        return
    noise = torch.Generator("cuda").manual_seed(2)
    for with_images in (False, True):
        step = build_eval_step(bundle, with_images=with_images)
        trace(f"eval_step_b{B}_with_images_{with_images}{tag}",
              lambda: step(batch, noise))
    infer = build_infer_step(bundle)
    images = batch["color"][:SERVE_BATCH, 0].float() / 255.0
    trace(f"infer_b{SERVE_BATCH}{tag}", lambda: infer(images))


if __name__ == "__main__":
    main()
