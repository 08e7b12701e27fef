#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each timed on its own line:

0. a watchdog (any hang ends the run non-zero with a stack dump), the card's
   name and power limit, TF32 off;
1. the build of every CUDA kernel of the port (one nvcc call);
2. each kernel against its plain PyTorch version on the card, at the
   step's shapes (B=12, C=3, 192x640), on a small-motion grid and on a wild
   grid that reaches the borders (K1-K4 also at B=2, 50x70, 50x68 and
   B=1, 9x33, where the tiles hang past the image, and with 4 and 1
   channels; K4 with and without the target's gradient), with its time
   (warm, and with the L2 flushed before each launch) beside the plain
   version's, the card's bound and, for the warp, F.grid_sample's: the
   forward kernels K1, K3, K5 and the backward kernels K2, K4;
3. the validation step at batch 12, 640x192, random weights from a seed,
   with and without the warped images, with the kernel launches it makes,
   after a check of the card's validation and inference steps against the
   CPU's on the same weights and inputs at a small size;
4. depth serving: 16 requests from 4 threads through MicroBatcher into an
   InferenceEngine with max_batch=8;
5. the training step (forward, loss, backward, Adam) at batch 12, 640x192,
   three steps with the fused warp + loss kernels (K1/K2) and three with
   the warp and loss kernels (K5, K3/K4), with the kernel launches of each
   step, after a check of two training steps on the card against the CPU's
   on the same weights, noise and augmentation at a small size;
6. the warp ladder of ``pallas_warp_version`` 1-7: the corner-fetch
   kernels K6 (narrow and wide band, per-block and per-row band starts),
   K7 and K8 against their plain versions on grids that meet their gates
   and on the wild grid, timed like phase 2; K7 and K8 also with index
   tensors that are not 16-byte aligned, and at B=2, 32x70 (K7: a ragged
   last run of pixels) and B=1, 24x256 (K8: a last row block hanging past
   the image) with 3, 1 and 4 channels; each version's rung on a
   small-motion grid (its top rung), a vertical wave (wide-band v3) and
   the wild grid (the gather);
   one training step at version 6 on the card against the CPU at a small
   size; then at batch 12, 640x192, one validation step at version 4, one
   at version 6 and three training steps at version 7, with each step's
   kernel launches.

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
    # the warp rebuilt (lerp and its two gradient planes: 12 per channel,
    # 10 for the coordinates); SSIM/L1 adjoint: 115 per channel for the
    # moments and coefficient planes, 9 per adjoint plane (3 here), 10 to
    # combine, 4 to contract
    "warp_reproj_loss_bwd": dict(
        source="unsupervised_pose_estimation_tpu_torch/csrc/"
               "warp_loss_bwd.cu",
        replaces="unsupervised_pose_estimation_tpu/ops/pallas/"
                 "warp_loss.py:252",
        flops_per_pixel=168 * C + 10),
    # 122 for the moments and the four coefficient planes, 36 for their
    # adjoints, 17 to combine both gradients
    "reproj_loss_bwd": dict(
        source="unsupervised_pose_estimation_tpu_torch/csrc/"
               "reproj_loss_bwd.cu",
        replaces="unsupervised_pose_estimation_tpu/ops/pallas/"
                 "reproj_loss.py:97",
        flops_per_pixel=175 * C),
    # the corner fetches gather and do no arithmetic: bound by their bytes
    "fetch_corners": dict(
        source="unsupervised_pose_estimation_tpu_torch/csrc/corners.cu",
        replaces="unsupervised_pose_estimation_tpu/ops/pallas/"
                 "warp_kernel.py:43",
        flops_per_pixel=0),
    "fetch_corners_packed": dict(
        source="unsupervised_pose_estimation_tpu_torch/csrc/corners.cu",
        replaces="unsupervised_pose_estimation_tpu/ops/pallas/"
                 "warp_kernel.py:450",
        flops_per_pixel=0),
    "fetch_corners_packed_v7": dict(
        source="unsupervised_pose_estimation_tpu_torch/csrc/corners.cu",
        replaces="unsupervised_pose_estimation_tpu/ops/pallas/"
                 "warp_kernel.py:529",
        flops_per_pixel=0),
}
CORNER_KERNELS = ("fetch_corners", "fetch_corners_packed",
                  "fetch_corners_packed_v7")


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


def cuda_ms_cold(fn, iters=20, flush_mib=256):
    """Mean device time of ``fn()`` in ms with a cold L2: a 256 MiB buffer
    (five times the 50 MB L2) is written before each launch, and each
    launch is timed by its own pair of CUDA events."""
    import torch

    flush = torch.empty(flush_mib << 18, dtype=torch.float32, device="cuda")
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(name, read_write_bytes, flops_per_pixel=None):
    """-> (bound_ms, bound_by): the larger of the bytes' time at the memory
    rate and the operations' time at the float32 rate (per pixel: the
    kernel's record's unless given)."""
    if flops_per_pixel is None:
        flops_per_pixel = KERNELS[name]["flops_per_pixel"]
    flops = flops_per_pixel * B * H * W
    t_bytes = read_write_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_inputs(gen, device, b=None, h=None, w=None, c=None):
    """Two uint8 frames and two planar grids (the main path's shapes unless
    given): small motion (a smooth shift of a few pixels) and wild (uniform
    over [-1.3, 1.3], so many samples clamp to the border, with the four
    border lines exactly at -1 and 1)."""
    import torch

    b, h, w, c = b or B, h or H, w or W, c or C
    src = torch.randint(0, 256, (b, h, w, c), generator=gen,
                        dtype=torch.uint8).to(device)
    tgt_u8 = torch.randint(0, 256, (b, h, w, c), generator=gen,
                           dtype=torch.uint8).to(device)
    target = (tgt_u8.float() / 255.0).permute(0, 3, 1, 2).contiguous()
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, h), torch.linspace(-1, 1, w),
                            indexing="ij")
    base = torch.stack([xs, ys], 0)[None].expand(b, 2, h, w)
    shift = (torch.rand((b, 2, 1, 1), generator=gen) - 0.5) * 0.02
    jitter = (torch.rand((b, 2, h, w), generator=gen) - 0.5) * 0.004
    small = (base + shift + jitter).contiguous().to(device)
    wild = (torch.rand((b, 2, h, w), generator=gen) * 2.6 - 1.3)
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
        """Max abs error; held at TOL, times the largest value where that
        exceeds 1 (the gradients)."""
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        tol = TOL * max([1.0] + [float(w.abs().max()) for w in want])
        ok = err <= tol and all(bool(torch.isfinite(g).all()) for g in got)
        print(f"  {name:20s} {label:17s} max_abs_err {err:.3e} "
              f"(tol {tol:.1e}) {'ok' if ok else 'FAIL'}", flush=True)
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
        cold_ms=cuda_ms_cold(lambda: K.warp(src, small)),
        plain_ms=cuda_ms(lambda: K.warp_plain(src, small)),
        library_ms=cuda_ms(lambda: F.grid_sample(
            img_f, grid_nhwc, mode="bilinear", padding_mode="border",
            align_corners=True)),
        bytes=nbytes(src, small, *out))

    # K1-K4, the fused warp + loss, the loss of a warped plane (K5's) and
    # their backward kernels, at the step's shape and at ragged shapes: H
    # and W not multiples of the 32 x 16 tile, reflect rows inside the
    # first and last tile; 50x68 with rows of whole float4s, so that its
    # interior tiles take the vector loads beside a last tile that does not;
    # there also with 4 and 1 channels (other instances of the kernels'
    # channel template; K2 and K4 at 4 channels take over 48 KB of shared
    # memory). K4 in both modes: without the target's gradient its dL/dpred
    # must be the same bits.
    g_up = torch.rand((B, H, W), generator=gen).to("cuda")
    rgen = torch.Generator().manual_seed(1)
    cases = [(src, target, small, wild, g_up, f"{B}x{H}x{W}")]
    for b, h, w, c in ((2, 50, 70, 3), (1, 9, 33, 3), (2, 50, 68, 3),
                       (2, 50, 70, 4), (1, 9, 33, 1)):
        cases.append((*make_inputs(rgen, "cuda", b, h, w, c),
                      torch.rand((b, h, w), generator=rgen).to("cuda"),
                      f"{b}x{h}x{w}" + ("" if c == C else f"x{c}")))
    errs = {name: [] for name in ("warp_reproj_loss", "warp_reproj_loss_bwd",
                                  "reproj_loss", "reproj_loss_bwd")}
    for s, t, sm, wi, gu, shape in cases:
        for g, label in ((sm, "small"), (wi, "wild")):
            tag = f"{label} {shape}"
            errs["warp_reproj_loss"].append(compare(
                "warp_reproj_loss", [K.warp_reproj_loss(s, g, t)],
                [K.warp_reproj_loss_plain(s, g, t)], tag))
            args = (s, g, t, gu)
            errs["warp_reproj_loss_bwd"].append(compare(
                "warp_reproj_loss_bwd", K.warp_reproj_loss_bwd(*args),
                K.warp_reproj_loss_bwd_plain(*args), tag))
            p = K.warp(s, g)[0]
            errs["reproj_loss"].append(compare(
                "reproj_loss", [K.reproj_loss(p, t)],
                [K.reproj_loss_plain(p, t)], tag))
            both = K.reproj_loss_bwd(p, t, gu)
            errs["reproj_loss_bwd"].append(compare(
                "reproj_loss_bwd", both, K.reproj_loss_bwd_plain(p, t, gu),
                tag))
            gp, gt = K.reproj_loss_bwd(p, t, gu, with_target=False)
            errs["reproj_loss_bwd"].append(compare(
                "reproj_loss_bwd", [gp], K.reproj_loss_bwd_plain(
                    p, t, gu, with_target=False)[:1], tag + " gp only"))
            if gt is not None or not torch.equal(gp, both[0]):
                raise AssertionError(f"reproj_loss_bwd without the target "
                                     f"({tag}): gp differs from the "
                                     f"both-gradients call's, or a target "
                                     f"gradient came back")
    loss = K.warp_reproj_loss(src, small, target)
    records["warp_reproj_loss"] = dict(
        max_abs_err=max(errs["warp_reproj_loss"]),
        ms=cuda_ms(lambda: K.warp_reproj_loss(src, small, target)),
        cold_ms=cuda_ms_cold(lambda: K.warp_reproj_loss(src, small, target)),
        plain_ms=cuda_ms(lambda: K.warp_reproj_loss_plain(src, small,
                                                          target)),
        library_ms=None,
        bytes=nbytes(src, small, target, loss))
    args = (src, small, target, g_up)
    records["warp_reproj_loss_bwd"] = dict(
        max_abs_err=max(errs["warp_reproj_loss_bwd"]),
        ms=cuda_ms(lambda: K.warp_reproj_loss_bwd(*args)),
        cold_ms=cuda_ms_cold(lambda: K.warp_reproj_loss_bwd(*args)),
        plain_ms=cuda_ms(lambda: K.warp_reproj_loss_bwd_plain(*args)),
        library_ms=None,
        bytes=nbytes(*args, *K.warp_reproj_loss_bwd(*args)))

    # K3 and K4 timed on the small-motion warp against the target; K4's
    # record in the mode with both gradients
    warped = out[0]
    loss = K.reproj_loss(warped, target)
    records["reproj_loss"] = dict(
        max_abs_err=max(errs["reproj_loss"]),
        ms=cuda_ms(lambda: K.reproj_loss(warped, target)),
        cold_ms=cuda_ms_cold(lambda: K.reproj_loss(warped, target)),
        plain_ms=cuda_ms(lambda: K.reproj_loss_plain(warped, target)),
        library_ms=None,
        bytes=nbytes(warped, target, loss))
    args = (warped, target, g_up)
    records["reproj_loss_bwd"] = dict(
        max_abs_err=max(errs["reproj_loss_bwd"]),
        ms=cuda_ms(lambda: K.reproj_loss_bwd(*args)),
        cold_ms=cuda_ms_cold(lambda: K.reproj_loss_bwd(*args)),
        plain_ms=cuda_ms(lambda: K.reproj_loss_bwd_plain(*args)),
        library_ms=None,
        bytes=nbytes(*args, *K.reproj_loss_bwd(*args)))

    def gp_only():
        return K.reproj_loss_bwd(*args, with_target=False)

    # the training step's mode, without the target's gradient: its own
    # bytes and operations (154 per channel: no c_mu_t, no adjoint of it)
    bound_ms, bound_by = bound("reproj_loss_bwd",
                               nbytes(*args, gp_only()[0]), 154 * C)
    print(f"  {'reproj_loss_bwd':20s} gp only: kernel "
          f"{cuda_ms(gp_only):.4f} ms  cold {cuda_ms_cold(gp_only):.4f} ms  "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)

    for name, rec in records.items():
        rec["bound_ms"], rec["bound_by"] = bound(name, rec.pop("bytes"))
        lib = rec["library_ms"]
        print(f"  {name:20s} kernel {rec['ms']:.4f} ms  cold "
              f"{rec['cold_ms']:.4f} ms  plain "
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
    none = {name: 0 for name in KERNELS}
    expect = {False: {**none, "warp_reproj_loss": 8, "reproj_loss": 2},
              True: {**none, "reproj_loss": 10, "warp": 8}}
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


# jitter factors [enabled, brightness, contrast, saturation, hue,
# autocontrast] of the training batches, cycled over the items
AUG_ROWS = [[1.0, 1.1, 0.9, 1.15, 0.05, 1.0], [1.0, 0.9, 1.1, 0.85, -0.04, 0.0],
            [0.0, 1.0, 1.0, 1.0, 0.0, 0.0]]
LR = 1e-4


def train_batch(gen, device, b=None, h=None, w=None):
    """A training batch: smoke_batch's frames and intrinsics, and per-item
    jitter factors (aug_params) in place of color_aug."""
    import torch

    batch = smoke_batch(gen, device, b, h, w)
    del batch["color_aug"]
    n = batch["color"].shape[0]
    rows = torch.tensor(AUG_ROWS, dtype=torch.float32)
    batch["aug_params"] = rows[torch.arange(n) % len(AUG_ROWS)].to(device)
    return batch


def check_train_against_cpu(device, version=8, steps=2, networks=True):
    """Two training steps on the card against the same two on the CPU
    (plain kernel versions), at B=2, 64x128, with the same batch,
    augmentation and automask noise. Each step starts both sides from the
    CPU's weights and statistics (each keeps its own Adam moments). The
    augmented frames must agree exactly (every stage floors onto the 0..255
    grid). Per step: the losses to 1e-4 relative; every parameter within
    2 lr after Adam (its first updates are about lr * sign(g), so an
    element whose gradient is at the level of float32 rounding can move
    2 lr apart) plus 1e-6 for the rounding of parameters of order 1; the
    BatchNorm statistics to 2e-5. The gradients: in float32 a ReLU input
    or a sampling coordinate within rounding of its kink can take the other
    branch on one side; in the pose network, whose deepest maps hold 32
    values per channel at this size, one such flip moves a leaf's gradient
    by percents (on an H100, step 2: 18% of pose.net.0.weight's largest
    value). So the float32 gradient norm is held to 1e-4 relative at step 1
    (read 1.1e-5) and 1e-3 at step 2 (1.9e-4, past such a flip), the whole
    gradient to 5e-2 in L2 (read 1.2e-3 and 2.2e-2), and each parameter's
    gradient to 1e-10 of its own largest value in float64
    (``check_networks_float64``, read 3.4e-14). ``version`` is the warp
    ladder's (``pallas_warp_version``), ``steps`` how many steps run,
    ``networks`` whether the float64 network check follows."""
    import copy

    import torch

    from unsupervised_pose_estimation_tpu_torch.ops.augment_device import \
        batch_augment
    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle
    from unsupervised_pose_estimation_tpu_torch.train.state import \
        create_train_state
    from unsupervised_pose_estimation_tpu_torch.train.step import \
        build_train_step

    b, h, w = 2, 64, 128
    opt = smoke_options(b, h, w)
    opt.pallas_warp_version = version
    cpu = ModelBundle.create(opt, seed=3, device="cpu")
    card = copy.deepcopy(cpu).to(device)
    runs = [(x, create_train_state(x), build_train_step(x))
            for x in (cpu, card)]
    gen = torch.Generator().manual_seed(5)
    batch = train_batch(gen, "cpu", b, h, w)
    aug_err = float((batch_augment(batch["color"].to(device),
                                   batch["aug_params"].to(device)).cpu()
                     - batch_augment(batch["color"], batch["aug_params"])
                     ).abs().max())
    print(f"  augmentation, card vs CPU: max abs error {aug_err:.3e} "
          f"(tol 0)", flush=True)
    if aug_err != 0.0:
        raise AssertionError("batch_augment on the card differs from the "
                             "CPU")
    names = [n for n, _ in cpu.named_parameters()]
    for k in range(steps):
        card.load_state_dict(cpu.state_dict())
        noise = {s: torch.randn((b, h, w, 2), generator=gen) * 1e-5
                 for s in range(4)}
        want = runs[0][2](runs[0][1], batch, noise=noise)
        got = runs[1][2](runs[1][1], {n: v.to(device)
                                      for n, v in batch.items()},
                         noise={s: v.to(device) for s, v in noise.items()})
        rel = {n: abs(float(got[n]) - float(v)) / abs(float(v))
               for n, v in want.items()}
        worst = max((n for n in rel if n != "grad_norm"), key=rel.get)
        card_grads = dict(card.named_parameters())
        grad_l2 = math.sqrt(sum(
            float(((card_grads[n].grad.cpu() - p.grad).double() ** 2).sum())
            for n, p in cpu.named_parameters()) / sum(
            float((p.grad.double() ** 2).sum()) for p in cpu.parameters()))
        cpu_sd, card_sd = cpu.state_dict(), card.state_dict()
        diff = torch.cat([(card_sd[n].cpu() - cpu_sd[n]).abs().flatten()
                          for n in names])
        stats = max(float((card_sd[n].cpu() - cpu_sd[n]).abs().max())
                    for n in cpu_sd if "running" in n)
        norm_tol = 1e-4 if k == 0 else 1e-3
        print(f"  card vs CPU, version {version}, step {k + 1}: losses "
              f"worst relative error "
              f"{rel[worst]:.3e} ({worst}; tol 1e-4), grad_norm "
              f"{rel['grad_norm']:.3e} (tol {norm_tol:g}), gradient L2 "
              f"{grad_l2:.3e} (tol 5e-2), parameters max "
              f"{float(diff.max()) / LR:.3f} lr (tol 2 lr), statistics "
              f"{stats:.3e} (tol 2e-5)", flush=True)
        if not (rel[worst] <= 1e-4 and rel["grad_norm"] <= norm_tol
                and grad_l2 <= 5e-2
                and float(diff.max()) <= 2 * LR + 1e-6 and stats <= 2e-5):
            raise AssertionError(f"training step {k + 1} on the card "
                                 "disagrees with the CPU")
    if networks:
        check_networks_float64(cpu, device, batch_augment(
            batch["color"], batch["aug_params"]))


def check_networks_float64(bundle, device, aug):
    """The depth and pose networks in float64, train mode, on the card and
    on the CPU, under the same seeded cotangents on the disparities and
    poses: every parameter's gradient to 1e-10 of its own largest value,
    the running statistics to 1e-12."""
    import copy

    import torch

    from unsupervised_pose_estimation_tpu_torch.train.step import \
        predict_poses

    frames = {f: aug[:, i].permute(0, 3, 1, 2).double()
              for i, f in enumerate(bundle.cfg.frame_ids)}
    gen = torch.Generator().manual_seed(9)
    cot = None
    grads, stats = [], []
    for dev in ("cpu", device):
        net = copy.deepcopy(bundle).double().to(dev).train(True)
        net.zero_grad(set_to_none=True)
        disps = net.depth(net.encoder(frames[0].to(dev)))
        poses = predict_poses(net, {f: x.to(dev) for f, x in frames.items()})
        outs = [*disps.values(), *poses.values()]
        if cot is None:
            cot = [torch.randn(o.shape, generator=gen, dtype=torch.float64)
                   for o in outs]
        sum((o * c.to(dev)).sum() for o, c in zip(outs, cot)).backward()
        grads.append({n: p.grad.cpu() for n, p in net.named_parameters()})
        stats.append({n: t.cpu() for n, t in net.state_dict().items()
                      if "running" in n})
    worst = max((float((grads[1][n] - g).abs().max())
                 / float(g.abs().max()), n) for n, g in grads[0].items())
    stat_err = max(float((stats[1][n] - t).abs().max())
                   for n, t in stats[0].items())
    print(f"  networks in float64, card vs CPU: gradients worst "
          f"{worst[0]:.3e} of the leaf's largest ({worst[1]}; tol 1e-10), "
          f"statistics {stat_err:.3e} (tol 1e-12)", flush=True)
    if not (worst[0] <= 1e-10 and stat_err <= 1e-12):
        raise AssertionError("float64 network gradients on the card "
                             "disagree with the CPU")


@phase("train_step")
def phase_train_step(device="cuda"):
    """Three training steps in each warp + loss mode on one bundle; asserts
    finite losses, changed parameters and each step's kernel launches;
    -> launches of the whole phase."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle
    from unsupervised_pose_estimation_tpu_torch.train.state import \
        create_train_state
    from unsupervised_pose_estimation_tpu_torch.train.step import \
        build_train_step

    check_train_against_cpu(device)
    bundle = ModelBundle.create(smoke_options(), seed=0, device=device)
    state = create_train_state(bundle)
    step = build_train_step(bundle)
    batch = train_batch(torch.Generator().manual_seed(6), device)
    none = {name: 0 for name in KERNELS}
    expect = {True: {**none, "warp_reproj_loss": 8, "warp_reproj_loss_bwd": 8,
                     "reproj_loss": 2},
              False: {**none, "warp": 8, "reproj_loss": 10,
                      "reproj_loss_bwd": 8}}
    watched = [bundle.encoder.encoder.conv1.weight, bundle.depth.bn[0].bias,
               bundle.pose_encoder.encoder.conv1.weight,
               bundle.pose.net[3].bias]
    total = dict(none)
    for fused in (True, False):
        bundle.cfg.use_pallas_warp_loss = fused
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            before = [p.detach().clone() for p in watched]
            K.reset_counts()
            start = time.perf_counter()
            losses = step(state, batch)
            if device == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
            launches = K.counts()
            values = {k: float(v) for k, v in losses.items()}
            bad = [k for k, v in values.items() if not math.isfinite(v)]
            if bad:
                raise AssertionError(f"non-finite losses {bad}")
            if launches != expect[fused]:
                raise AssertionError(f"fused={fused}: launches {launches}, "
                                     f"expected {expect[fused]}")
            if any(torch.equal(b, p) for b, p in zip(before, watched)):
                raise AssertionError("a training step left parameters as "
                                     "they were")
            for name in total:
                total[name] += launches[name]
            print(f"  fused={fused} step {state.step}: "
                  f"{1e3 * times[-1]:.1f} ms, loss {values['loss']:.6f}, "
                  f"grad_norm {values['grad_norm']:.6f}, launches "
                  f"{launches}", flush=True)
        # steady state: the first step includes cuDNN's algorithm choice
        print(f"  fused={fused}: steady wall ms per step "
              f"{[round(1e3 * t, 3) for t in times[1:]]}", flush=True)
        if device == "cuda":
            print(f"  fused={fused}: peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
                  flush=True)
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


def wave_grid(device):
    """The identity grid plus a vertical sinusoid of +-20 rows along x: an
    8-row block spans ~48 rows, past the 40-row band and inside 72."""
    import torch

    ys, xs = torch.meshgrid(torch.linspace(-1, 1, H), torch.linspace(-1, 1, W),
                            indexing="ij")
    wave = (20.0 * (2.0 / (H - 1))) * torch.sin(
        torch.linspace(0, 6 * math.pi, W))
    grid = torch.stack([xs, ys + wave[None]], 0)[None].expand(B, 2, H, W)
    return grid.contiguous().to(device)


def rung_inputs(grid, version, rung, gate=True):
    """The indices ``rung`` of ``version``'s ladder gives its corner fetch
    for ``grid`` (the main path's shapes): x0i, yl, ymin, band; raises if
    ``gate`` and the grid misses the rung's gate."""
    from unsupervised_pose_estimation_tpu_torch.ops.kernels.corners import \
        expand_starts
    from unsupervised_pose_estimation_tpu_torch.ops.kernels.warp import (
        ladder, taps)

    _, _, h, w = grid.shape
    x0i, y0i, _, _ = taps(grid)
    rungs = {r[0]: r for r in ladder(version, True, x0i, y0i, h, w)}
    _, ymin, band, ok = rungs[rung]
    if gate and not bool(ok):
        raise AssertionError(f"the grid misses the gate of {rung}")
    return x0i, y0i - expand_starts(ymin, h, w), ymin, band


def packed_inputs(name, grid):
    """K7's or K8's indices for ``grid`` at any shape its wrapper takes
    (the ladder's needs W % 128 == 0): band starts as the ladder forms
    them, one per 16 rows (K7, band min(40, H)) or per row and 128-column
    chunk (K8, band 16); -> the wrapper's index arguments."""
    from unsupervised_pose_estimation_tpu_torch.ops.kernels.corners import \
        expand_starts
    from unsupervised_pose_estimation_tpu_torch.ops.kernels.warp import (
        _band, taps)

    b, _, h, w = grid.shape
    x0i, y0i, _, _ = taps(grid)
    if name == "fetch_corners_packed":
        band = min(40, h)
        blocks = y0i.reshape(b, h // 16, 16 * w)
        ymin = _band(blocks.amin(2), blocks.amax(2), h, band)[0][..., None]
        return x0i, y0i - expand_starts(ymin, h, w), ymin, band
    blocks = y0i.reshape(b, h, w // 128, 128)
    ymin = _band(blocks.amin(3), blocks.amax(3), h, 16)[0]
    return x0i, y0i - expand_starts(ymin, h, w), ymin


def offset_view(t):
    """A contiguous copy of ``t`` one element into its storage, so that its
    data pointer is not 16-byte aligned."""
    buf = t.new_empty(t.numel() + 1)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 16 == 0:
        raise AssertionError("the offset view is 16-byte aligned")
    return view


# K7 and K8 at shapes that reach the packed kernel's edge paths: a ragged
# last run (W=70: 8 runs of 8 and one of 6), a last row block hanging past
# the image (H=24 on 16-row blocks), 1 and 4 channels; (name, B, H, W, C)
PACKED_EDGES = [("fetch_corners_packed", 2, 32, 70, c) for c in (3, 1, 4)] + [
    ("fetch_corners_packed_v7", 1, 24, 256, c) for c in (3, 1, 4)]


def check_corner_kernels(src, small, wave, wild):
    """K6 (narrow band, wide band, per-row starts), K7 and K8 against their
    plain versions, on a grid that meets the rung's gate and on the wild
    grid (where the gate fails and the ladder would not call them, but
    kernel and plain version still gather the same clamped taps); K7 and K8
    also at the PACKED_EDGES shapes and with index tensors that are not
    16-byte aligned, each on a small-motion and a wild grid; -> {name:
    record}."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.ops.kernels.warp import \
        frame_planes

    planes = frame_planes(src).reshape(B * C, H, W)
    pairs = {"fetch_corners": (K.fetch_corners, K.fetch_corners_plain),
             "fetch_corners_packed": (K.fetch_corners_packed,
                                      K.fetch_corners_packed_plain),
             "fetch_corners_packed_v7": (K.fetch_corners_packed_v7,
                                         K.fetch_corners_packed_v7_plain)}
    errs = {name: 0.0 for name in CORNER_KERNELS}

    def compare(name, args, tag):
        kern, plain = pairs[name]
        got, want = kern(*args), plain(*args)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        print(f"  {name:24s} {tag:24s} max_abs_err {err:.3e} (tol 0)",
              flush=True)
        if err != 0.0 or any(a.dtype != b.dtype for a, b in zip(got, want)):
            raise AssertionError(f"{name} ({tag}) disagrees with its plain "
                                 f"version: {err}")
        errs[name] = max(errs[name], err)

    cases = [("fetch_corners", "v4", 4, small, "narrow"),
             ("fetch_corners", "v3_wide", 3, wave, "wide"),
             ("fetch_corners", "v2", 2, small, "per-row"),
             ("fetch_corners_packed", "v6", 6, small, "small"),
             ("fetch_corners_packed_v7", "v7", 7, small, "small")]
    calls = {}  # name -> args at the main path's shapes
    for name, rung, version, grid, label in cases:
        for g, tag, gate in ((grid, label, True), (wild, label + "/wild",
                                                    False)):
            x0i, yl, ymin, band = rung_inputs(g, version, rung, gate)
            first = (planes if name == "fetch_corners" else src,
                     x0i, yl, ymin)
            args = first if name == "fetch_corners_packed_v7" else (
                *first, band)
            compare(name, args, tag)
            if name != "fetch_corners":
                compare(name, (args[0], offset_view(x0i), offset_view(yl),
                               *args[3:]), tag + "/offset")
            if gate and name not in calls:
                calls[name] = args
    gen = torch.Generator().manual_seed(20)
    for name, b, h, w, c in PACKED_EDGES:
        image, _, e_small, e_wild = make_inputs(gen, src.device, b, h, w, c)
        for g, label in ((e_small, "small"), (e_wild, "wild")):
            x0i, yl, *rest = packed_inputs(name, g)
            tag = f"{b}x{h}x{w}x{c}/{label}"
            compare(name, (image, x0i, yl, *rest), tag)
            compare(name, (image, offset_view(x0i), offset_view(yl), *rest),
                    tag + "/offset")
    records = {}
    for name, args in calls.items():
        kern, plain = pairs[name]
        records[name] = rec = dict(
            max_abs_err=errs[name], ms=cuda_ms(lambda: kern(*args)),
            cold_ms=cuda_ms_cold(lambda: kern(*args)),
            plain_ms=cuda_ms(lambda: plain(*args)), library_ms=None)
        rec["bound_ms"], rec["bound_by"] = bound(
            name, nbytes(*args[:4], *kern(*args)))
        print(f"  {name:24s} kernel {rec['ms']:.4f} ms  cold "
              f"{rec['cold_ms']:.4f} ms  plain "
              f"{rec['plain_ms']:.4f} ms  bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})", flush=True)
    return records


def check_rungs(src, small, wave, wild):
    """Versions 1-7 on the small-motion grid (each version's top rung), the
    wave (wide-band v3; v2 has none and gathers) and the wild grid (the
    gather); each warp against K5 at 1e-6 (the ladder scales by 1/255
    before the lerp, K5 after it: a few ulp)."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K

    with torch.no_grad():
        k5 = {label: K.warp(src, g)[0] for label, g in
              (("small", small), ("wave", wave), ("wild", wild))}
        for version in range(1, 8):
            chosen = []
            for label, grid in (("small", small), ("wave", wave),
                                ("wild", wild)):
                want = {"small": f"v{version}", "wild": "gather",
                        "wave": "gather" if version == 2 else "v3_wide"}
                K.reset_counts()
                out = K.grid_sample_fast(src, grid, planar_out=True,
                                         version=version, planar_grid=True)
                rungs = K.rung_counts()
                err = float((out - k5[label]).abs().max())
                chosen.append(f"{label}->{max(rungs, key=rungs.get)} "
                              f"(vs K5 {err:.1e})")
                if rungs[want[label]] != 1 or sum(rungs.values()) != 1:
                    raise AssertionError(f"version {version}, {label} grid: "
                                         f"rungs {rungs}, expected "
                                         f"{want[label]}")
                if not err <= 1e-6:
                    raise AssertionError(f"version {version}, {label} grid: "
                                         f"the ladder is {err} from K5")
            print(f"  version {version}: {', '.join(chosen)}", flush=True)


def ladder_launches(launches, rungs, train):
    """Per step through the ladder: 8 warps, each a corner-fetch launch or
    a plain gather; 10 x K3 (8 warps + 2 identity terms), 8 x K4 in
    training; none of K1, K2, K5."""
    corners = sum(launches[name] for name in CORNER_KERNELS)
    others = {name: n for name, n in launches.items()
              if name not in CORNER_KERNELS}
    want = {name: 0 for name in others}
    want.update(reproj_loss=10, reproj_loss_bwd=8 if train else 0)
    if corners + rungs["gather"] != 8 or others != want:
        raise AssertionError(f"launches {launches}, rungs {rungs}: expected "
                             f"8 corner fetches or gathers and {want}")


@phase("ladder")
def phase_ladder(device="cuda"):
    """The corner kernels, the rung choice, a card-vs-CPU training step at
    version 6, then the validation step at versions 4 and 6 and three
    training steps at version 7 at batch 12; -> (kernel records, launches
    of the steps)."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle
    from unsupervised_pose_estimation_tpu_torch.train.state import \
        create_train_state
    from unsupervised_pose_estimation_tpu_torch.train.step import (
        build_eval_step, build_train_step)

    gen = torch.Generator().manual_seed(10)
    src, _, small, wild = make_inputs(gen, device)
    wave = wave_grid(device)
    records = check_corner_kernels(src, small, wave, wild)
    check_rungs(src, small, wave, wild)
    check_train_against_cpu(device, version=6, steps=1, networks=False)

    bundle = ModelBundle.create(smoke_options(), seed=0, device=device)
    total = {name: 0 for name in KERNELS}
    runs = [("eval", 4), ("eval", 6)] + [("train", 7)] * 3
    state = create_train_state(bundle)
    batch = train_batch(torch.Generator().manual_seed(11), device)
    eval_batch = smoke_batch(torch.Generator().manual_seed(12), device)
    for kind, version in runs:
        bundle.cfg.pallas_warp_version = version
        K.reset_counts()
        start = time.perf_counter()
        if kind == "eval":
            losses, _ = build_eval_step(bundle)(
                eval_batch, torch.Generator(device).manual_seed(2))
        else:
            losses = build_train_step(bundle)(state, batch)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches, rungs = K.counts(), K.rung_counts()
        values = {k: float(v) for k, v in losses.items()}
        bad = [k for k, v in values.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite losses {bad}")
        ladder_launches(launches, rungs, kind == "train")
        for name in total:
            total[name] += launches[name]
        print(f"  {kind} step, version {version}: {1e3 * seconds:.1f} ms, "
              f"loss {values['loss']:.6f}, rungs "
              f"{ {k: n for k, n in rungs.items() if n} }, launches "
              f"{ {k: n for k, n in launches.items() if n} }", flush=True)
    return records, total


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
    for name, n in phase_train_step().items():
        launches[name] += n
    ladder_records, ladder_total = phase_ladder()
    records.update(ladder_records)
    for name, n in ladder_total.items():
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
