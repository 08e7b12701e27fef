#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each timed on its own line:

0. a watchdog (any hang ends the run non-zero with a stack dump), the card's
   name and power limit, TF32 off;
1. the build of every CUDA kernel of the port (one nvcc call);
2. each kernel against its plain PyTorch version on the card, at the
   validation step's shapes (B=12, C=3, 192x640), on a small-motion grid
   and on a wild grid that reaches the borders, with its time beside the
   plain version's, the card's bound and, for the warp, F.grid_sample's;
3. the validation step at batch 12, 640x192, random weights from a seed,
   with and without the warped images, with the kernel launches it makes,
   after a check of the card's validation and inference steps against the
   CPU's on the same weights and inputs at a small size;
4. depth serving: 16 requests from 4 threads through MicroBatcher into an
   InferenceEngine with max_batch=8.

It prints one JSON line of kernel records, then, as its last line, the
device record. Any failure ends it with a non-zero exit code; without a
CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import faulthandler
import json
import math
import subprocess
import sys
import threading
import time

WATCHDOG_S = 600
B, C, H, W = 12, 3, 192, 640
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TOL = 1e-5                  # max abs error of a kernel against its twin

# Kernel records: source, the TPU kernel it replaces, and the float
# operations per output pixel the bound counts (lerp: 12 per channel plus
# 10 for the coordinates; SSIM + L1 score: 79 per channel).
KERNELS = {
    "warp_reproj_loss": dict(
        source="unsupervised_pose_estimation_tpu_torch/csrc/warp_loss.cu",
        replaces="unsupervised_pose_estimation_tpu/ops/pallas/"
                 "warp_loss.py:50",
        flops_per_pixel=91 * C + 10),
    "reproj_loss": dict(
        source="unsupervised_pose_estimation_tpu_torch/csrc/reproj_loss.cu",
        replaces="unsupervised_pose_estimation_tpu/ops/pallas/"
                 "reproj_loss.py:51",
        flops_per_pixel=79 * C),
    "warp": dict(
        source="unsupervised_pose_estimation_tpu_torch/csrc/warp.cu",
        replaces="unsupervised_pose_estimation_tpu/ops/pallas/"
                 "warp_kernel.py:606",
        flops_per_pixel=12 * C + 10),
}


def phase(name):
    """Decorator printing a phase's wall time."""
    def wrap(fn):
        def run(*args, **kwargs):
            start = time.perf_counter()
            print(f"[{name}] start", flush=True)
            out = fn(*args, **kwargs)
            print(f"[{name}] done in {time.perf_counter() - start:.2f} s",
                  flush=True)
            return out
        return run
    return wrap


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` in ms, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(name, read_write_bytes):
    """-> (bound_ms, bound_by): the larger of the bytes' time at the memory
    rate and the operations' time at the float32 rate."""
    flops = KERNELS[name]["flops_per_pixel"] * B * H * W
    t_bytes = read_write_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_inputs(gen, device):
    """Two uint8 frames and two planar grids: small motion (a smooth shift of
    a few pixels) and wild (uniform over [-1.3, 1.3], so many samples clamp
    to the border, with the four border lines exactly at -1 and 1)."""
    import torch

    src = torch.randint(0, 256, (B, H, W, C), generator=gen,
                        dtype=torch.uint8).to(device)
    tgt_u8 = torch.randint(0, 256, (B, H, W, C), generator=gen,
                           dtype=torch.uint8).to(device)
    target = (tgt_u8.float() / 255.0).permute(0, 3, 1, 2).contiguous()
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, H), torch.linspace(-1, 1, W),
                            indexing="ij")
    base = torch.stack([xs, ys], 0)[None].expand(B, 2, H, W)
    shift = (torch.rand((B, 2, 1, 1), generator=gen) - 0.5) * 0.02
    jitter = (torch.rand((B, 2, H, W), generator=gen) - 0.5) * 0.004
    small = (base + shift + jitter).contiguous().to(device)
    wild = (torch.rand((B, 2, H, W), generator=gen) * 2.6 - 1.3)
    wild[:, :, 0, :] = -1.0
    wild[:, :, -1, :] = 1.0
    wild[:, :, :, 0] = -1.0
    wild[:, :, :, -1] = 1.0
    return src, target, small, wild.contiguous().to(device)


@phase("kernels")
def phase_kernels():
    """Each kernel against its plain twin; -> {name: record}."""
    import torch
    import torch.nn.functional as F

    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K

    gen = torch.Generator().manual_seed(0)
    src, target, small, wild = make_inputs(gen, "cuda")
    records = {}

    def compare(name, got, want, label):
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = err <= TOL and all(bool(torch.isfinite(g).all()) for g in got)
        print(f"  {name:17s} {label:6s} max_abs_err {err:.3e} "
              f"(tol {TOL:.0e}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the {label} grid: {err}")
        return err

    # K5: warp
    errs = [compare("warp", K.warp(src, g), K.warp_plain(src, g), label)
            for g, label in ((small, "small"), (wild, "wild"))]
    out = K.warp(src, small)
    img_f = (src.float() / 255.0).permute(0, 3, 1, 2).contiguous()
    grid_nhwc = small.permute(0, 2, 3, 1).contiguous()
    records["warp"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: K.warp(src, small)),
        plain_ms=cuda_ms(lambda: K.warp_plain(src, small)),
        library_ms=cuda_ms(lambda: F.grid_sample(
            img_f, grid_nhwc, mode="bilinear", padding_mode="border",
            align_corners=True)),
        bytes=nbytes(src, small, *out))

    # K3: reprojection loss of the small-motion warp against the target
    warped = out[0]
    errs = [compare("reproj_loss", [K.reproj_loss(p, target)],
                    [K.reproj_loss_plain(p, target)], label)
            for p, label in ((warped, "small"), (K.warp(src, wild)[0], "wild"))]
    loss = K.reproj_loss(warped, target)
    records["reproj_loss"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: K.reproj_loss(warped, target)),
        plain_ms=cuda_ms(lambda: K.reproj_loss_plain(warped, target)),
        library_ms=None,
        bytes=nbytes(warped, target, loss))

    # K1: fused warp + loss, with and without the residual planes
    errs = []
    for g, label in ((small, "small"), (wild, "wild")):
        errs.append(compare("warp_reproj_loss",
                            [K.warp_reproj_loss(src, g, target)],
                            [K.warp_reproj_loss_plain(src, g, target)], label))
        errs.append(compare(
            "warp_reproj_loss", K.warp_reproj_loss(src, g, target, True),
            K.warp_reproj_loss_plain(src, g, target, True), label + "+res"))
    loss = K.warp_reproj_loss(src, small, target)
    records["warp_reproj_loss"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: K.warp_reproj_loss(src, small, target)),
        plain_ms=cuda_ms(lambda: K.warp_reproj_loss_plain(src, small,
                                                          target)),
        library_ms=None,
        bytes=nbytes(src, small, target, loss))

    for name, rec in records.items():
        rec["bound_ms"], rec["bound_by"] = bound(name, rec.pop("bytes"))
        lib = rec["library_ms"]
        print(f"  {name:17s} kernel {rec['ms']:.4f} ms  plain "
              f"{rec['plain_ms']:.4f} ms  bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})  library "
              f"{'-' if lib is None else f'{lib:.4f} ms'}", flush=True)
    return records


def smoke_batch(gen, device, b=None, h=None, w=None):
    """A validation batch (the main path's shapes unless given): three
    random uint8 frames per item and KITTI-like normalised intrinsics."""
    import torch

    b, h, w = b or B, h or H, w or W
    color = torch.randint(0, 256, (b, 3, h, w, 3), generator=gen,
                          dtype=torch.uint8)
    K_norm = torch.tensor([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0],
                           [0, 0, 1, 0], [0, 0, 0, 1]], dtype=torch.float32)
    return {"color": color.to(device), "color_aug": color.clone().to(device),
            "K_norm": K_norm.expand(b, 4, 4).contiguous().to(device)}


def smoke_options(b=None, h=None, w=None):
    from unsupervised_pose_estimation_tpu_torch.config import Options

    return Options(height=h or H, width=w or W, batch_size=b or B,
                   compute_dtype="float32")


def check_against_cpu(device):
    """The validation and inference steps on the card against the same
    weights and inputs on the CPU (plain kernel versions, PyTorch's CPU
    convolutions), at B=2, 64x128. The automask noise is shared. cuDNN and
    the CPU sum the convolutions in other orders (cuDNN may pick FFT
    algorithms): losses are held to 1e-4 relative, disparities to 1e-4."""
    import copy

    import torch

    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle
    from unsupervised_pose_estimation_tpu_torch.train.step import (
        build_eval_step, build_infer_step)

    b, h, w = 2, 64, 128
    cpu = ModelBundle.create(smoke_options(b, h, w), seed=3, device="cpu")
    card = copy.deepcopy(cpu).to(device)
    gen = torch.Generator().manual_seed(4)
    batch = smoke_batch(gen, "cpu", b, h, w)
    noise = {s: torch.randn((b, h, w, 2), generator=gen) * 1e-5
             for s in range(4)}
    worst = 0.0
    for with_images in (False, True):
        want = build_eval_step(cpu, with_images)(batch, noise=noise)[0]
        got = build_eval_step(card, with_images)(
            {k: v.to(device) for k, v in batch.items()},
            noise={s: n.to(device) for s, n in noise.items()})[0]
        for key, ref in want.items():
            rel = abs(float(got[key]) - float(ref)) / abs(float(ref))
            worst = max(worst, rel)
            if not rel <= 1e-4:
                raise AssertionError(f"{key} on the card {float(got[key])} "
                                     f"vs the CPU {float(ref)}")
    images = batch["color"][:, 0].float() / 255.0
    want = build_infer_step(cpu)(images)[0]
    got = build_infer_step(card)(images.to(device))[0].cpu()
    disp_err = float((got - want).abs().max())
    if not disp_err <= 1e-4:
        raise AssertionError(f"disparity on the card differs by {disp_err}")
    print(f"  card vs CPU at B={b}, {w}x{h}: losses worst relative error "
          f"{worst:.3e} (tol 1e-4), disparity max abs error {disp_err:.3e} "
          f"(tol 1e-4)", flush=True)


@phase("eval_step")
def phase_eval_step(device="cuda"):
    """The validation step in both modes; asserts finite losses and the
    kernel launches of each mode; -> launches of the whole phase."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle
    from unsupervised_pose_estimation_tpu_torch.train.step import \
        build_eval_step

    check_against_cpu(device)
    opt = smoke_options()
    bundle = ModelBundle.create(opt, seed=0, device=device)
    gen = torch.Generator().manual_seed(1)
    batch = smoke_batch(gen, device)
    expect = {False: {"warp_reproj_loss": 8, "reproj_loss": 2, "warp": 0},
              True: {"warp_reproj_loss": 0, "reproj_loss": 10, "warp": 8}}
    total = {name: 0 for name in KERNELS}
    for with_images in (False, True):
        step = build_eval_step(bundle, with_images=with_images)
        K.reset_counts()
        start = time.perf_counter()
        losses, outputs = step(batch, torch.Generator(device).manual_seed(2))
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = K.counts()
        values = {k: float(v) for k, v in losses.items()}
        print(f"  with_images={with_images}: {seconds:.3f} s, launches "
              f"{launches}, loss {values['loss']:.6f}", flush=True)
        bad = [k for k, v in values.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite losses {bad}")
        if launches != expect[with_images]:
            raise AssertionError(f"with_images={with_images}: launches "
                                 f"{launches}, expected "
                                 f"{expect[with_images]}")
        if with_images:
            for key in ("color_pred/-1/0", "color_pred/1/3", "automask/0"):
                if not bool(torch.isfinite(outputs[key]).all()):
                    raise AssertionError(f"non-finite output {key}")
        for name in total:
            total[name] += launches[name]
        # steady state: the first call above includes cuDNN's algorithm
        # selection and the allocator's growth
        times = []
        for _ in range(5):
            start = time.perf_counter()
            step(batch, torch.Generator(device).manual_seed(2))
            if device == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
        print(f"  with_images={with_images}: steady wall ms "
              f"{sorted(1e3 * t for t in times)}", flush=True)
    return total


@phase("serve")
def phase_serve(device="cuda"):
    """16 requests from 4 threads through MicroBatcher -> InferenceEngine."""
    import numpy as np

    from unsupervised_pose_estimation_tpu_torch.serve import (InferenceEngine,
                                                               MicroBatcher)

    engine = InferenceEngine(smoke_options(), max_batch=8, device=device)
    batcher = MicroBatcher(engine, max_delay_ms=20.0)
    results, errors = [], []
    lock = threading.Lock()

    def client(k):
        rng = np.random.default_rng(k)
        for _ in range(4):
            img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            try:
                disp = batcher.submit(img, timeout=120.0)
            except Exception as err:  # reported below, fails the phase
                with lock:
                    errors.append(repr(err))
                return
            with lock:
                results.append(disp)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180.0)
    finally:
        batcher.close()
    if batcher.running:
        raise AssertionError("the batching thread did not stop")
    if any(t.is_alive() for t in threads) or errors:
        raise AssertionError(f"serving failed: {errors or 'client hung'}")
    if len(results) != 16:
        raise AssertionError(f"{len(results)} of 16 requests answered")
    for disp in results:
        if disp.shape != (H, W) or not np.isfinite(disp).all():
            raise AssertionError(f"bad disparity {disp.shape}")
    print(f"  16 requests answered, {engine.calls} engine calls, disp range "
          f"[{min(float(d.min()) for d in results):.4f}, "
          f"{max(float(d.max()) for d in results):.4f}]", flush=True)


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.ops.kernels import _lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    start = time.perf_counter()
    path = _lib.build()
    _lib.library()
    print(f"[build] {path.name} in {time.perf_counter() - start:.2f} s "
          f"(nvcc {_lib.build_seconds:.2f} s)", flush=True)
    if _lib.build_log:
        print(_lib.build_log.strip(), flush=True)

    records = phase_kernels()
    launches = phase_eval_step()
    K.reset_counts()
    phase_serve()
    for name, n in K.counts().items():
        launches[name] += n
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name]["source"],
             replaces=KERNELS[name]["replaces"], launches=launches[name],
             **records[name]) for name in KERNELS]}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
