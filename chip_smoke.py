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
   CPU's on the same weights and inputs at a small size; in float32, then
   with the networks in bfloat16 (``BF16_*``: held to the CPU's own
   bfloat16-against-float32 gap), with wall ms and peak memory;
4. depth serving: 16 requests from 4 threads through MicroBatcher into an
   InferenceEngine with max_batch=8, in float32 and in bfloat16 (after a
   check of a bfloat16 engine against the CPU's), with wall ms and peak
   memory;
5. the training step (forward, loss, backward, Adam) at batch 12, 640x192,
   three steps with the fused warp + loss kernels (K1/K2) and three with
   the warp and loss kernels (K5, K3/K4), with the kernel launches of each
   step, after a check of two training steps on the card against the CPU's
   on the same weights, noise and augmentation at a small size; in float32,
   then in bfloat16 (one step against the CPU's, held to its gap); each
   dtype's step also twice under the trainer's deterministic cuDNN (the
   same bits) and timed with and without it, in alternating rounds;
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
   kernel launches;
7. the training entry point, ``cli.train.main``, at its defaults
   (bfloat16) at batch 12, 640x192 on ``synthetic_parallax``: six steps
   with logs, validation and checkpoints at steps 3 and 6 (each consumed
   batch checked against the host's items); a second Trainer resumed from
   the checkpoint of step 3 (parameters, Adam moments and the batches of
   steps 4-6 bit-equal to the uninterrupted run's, losses within
   ``RESUME_LOSS_RTOL``, gradient norms within ``RESUME_NORM_RTOL``); two
   steps of the lung dataset from a frame cache written with numpy (no
   PIL); with wall ms per step, frames/s, the Loader's wait, peak device
   memory, TF32 and the card's power limit, and the K1-K3 launches of the
   phase;
8. evaluation: ``cli.evaluate_depth`` (mono, post-processed) and
   ``cli.evaluate_pose`` on phase 7's last checkpoint, over a split of
   ``synthetic_parallax`` items with their exact depth and poses, at the
   trainer's feed (timed) and, against the same entry points and functions
   on the CPU, at a small size;
9. the training options (``OPTION_GROUPS``: A, a shared pose network with
   the stereo frame and v1 multiscale; B, PoseCNN over all frames with the
   predictive mask and the upstream decoder; C, the separate pose network
   over all frames): each group's two training steps on the card against
   the CPU's at a small size, in float32 and in bfloat16 (as phase 5);
   K6 on a float frame at version 8 (v1 multiscale's scale-0 warp); each
   group's three training steps and one validation step at batch 12,
   640x192, in bfloat16 and in float32, with wall ms, peak memory,
   launches and the rungs of the
   float-frame warps, and the step repeated bit for bit under deterministic
   cuDNN; ``cli.train`` with ``OPTION_TRAIN_ARGS`` at 640x192 for three
   steps with a checkpoint at step 2 and a resumed step 3 that is
   bit-equal; ``cli.evaluate_depth`` and an ``InferenceEngine`` on a
   ``.pth`` folder whose ``depth.pth`` is an upstream decoder, each
   building the detected variant;
10. the GAN prior (``GAN_OPTIONS``: the frozen generator's silog term and
   the PatchGAN discriminator's step): two training steps, each followed
   by a disc step, on the card against the CPU's at a small size, in
   float32 and in bfloat16 (as phase 5, with the generator's output, the
   disc loss and the discriminator after its update); three training and
   disc steps and one validation step at batch 12, 640x192, in bfloat16
   and in float32, with wall ms of each step and disc step, peak memory
   and launches (K1/K2/K3 8/8/2 a training step), the step and the disc
   step repeated bit for bit under deterministic cuDNN; ``cli.train``
   with the prior and a generator ``.pth`` written from seeded weights
   for three steps, resumed from step 2 bit-equal (both Adams included);
   ``cli.evaluate_depth`` on that run's checkpoint;
11. the mesh (``parallel.mesh``) at the trainer's feed, ``MESH_*``: (a)
   ``cli.train`` for three steps without a process group and with an NCCL
   group of one process (torchrun's environment, WORLD_SIZE=1), losses
   and final parameters bit-equal, wall ms per step of each; (b) two
   ranks on the one card as two processes through gloo
   (``parallel.dryrun``), ``mesh_data=2`` and ``mesh_fsdp=2`` in float32
   (TF32 off) and ``mesh_data=2`` in bfloat16, three steps of six rows per
   rank, each step held to the one-process step from the same state
   (float32 at the CPU tests' bounds, bfloat16 at phase 5's), the ranks
   bit-identical after each step, fsdp's steps bit-equal to
   ``mesh_data=2``'s, a checkpoint at step 2 and a resume from it
   bit-equal; with each rank's ms per step, collectives, launches, peak
   memory and the bytes of parameters and Adam moments it holds;
12. files and serving without PIL: the native host routines of the image
   codec (``csrc/image_host.cpp``, built with the kernels) against their
   numpy versions bit for bit, the PNG unfilter on ``encode_png`` files of
   every colour type read with each forced filter type, mixed and adaptive
   ones at 1280x1024 and ragged sizes, the LANCZOS passes on the feeds'
   shapes, with host ms per frame of each route; a lung tree of 1280x1024
   PNGs, its split files (``data.make_splits``), ``cli.build_frame_cache``,
   ``cli.train`` for two steps from the files (``--log_images``, read back)
   and two from the cache, the batches bit-equal, frames/s of each; the
   HTTP front end with a bfloat16 and a float32 engine, 16 concurrent PNG
   POSTs each answered with the engine's disparity of its frame, p50 and
   p99 ms; ``export_artifact`` / ``load_artifact`` against the engine
   (float32 within 1e-6, bfloat16 within phase 4's bound);
   ``cli.test_simple`` on phase 7's checkpoint; ``cli.export_gt_depth`` on
   an eigen_benchmark tree of 16-bit PNGs; ``--eval_split benchmark``'s
   PNGs read back.

It prints one JSON line of the host routines' records and the HTTP
latencies, one JSON line of kernel records, then, as its last line, the
device record. Any failure ends it with a non-zero exit code; without a
CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

WATCHDOG_S = 900
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
    # memory); and the pyramid's levels 1-3 under v1_multiscale (phase 9's
    # group A runs K3 and K4 at these shapes). K4 in both modes: without
    # the target's gradient its dL/dpred must be the same bits.
    g_up = torch.rand((B, H, W), generator=gen).to("cuda")
    rgen = torch.Generator().manual_seed(1)
    cases = [(src, target, small, wild, g_up, f"{B}x{H}x{W}")]
    pyramid = tuple((B, H >> s, W >> s, C) for s in (1, 2, 3))
    for b, h, w, c in ((2, 50, 70, 3), (1, 9, 33, 3), (2, 50, 68, 3),
                       (2, 50, 70, 4), (1, 9, 33, 1)) + pyramid:
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


def smoke_batch(gen, device, b=None, h=None, w=None, stereo=False):
    """A validation batch (the main path's shapes unless given): three
    random uint8 frames per item and KITTI-like normalised intrinsics;
    with ``stereo`` a fourth frame and a stereo_T of baseline 0.1."""
    import torch

    b, h, w = b or B, h or H, w or W
    color = torch.randint(0, 256, (b, 3 + stereo, h, w, 3), generator=gen,
                          dtype=torch.uint8)
    K_norm = torch.tensor([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0],
                           [0, 0, 1, 0], [0, 0, 0, 1]], dtype=torch.float32)
    batch = {"color": color.to(device), "color_aug": color.clone().to(device),
             "K_norm": K_norm.expand(b, 4, 4).contiguous().to(device)}
    if stereo:
        stereo_T = torch.eye(4).repeat(b, 1, 1)
        stereo_T[:, 0, 3] = 0.1
        batch["stereo_T"] = stereo_T.to(device)
    return batch


def smoke_options(b=None, h=None, w=None, dtype="float32", **options):
    from unsupervised_pose_estimation_tpu_torch.config import Options

    return Options(height=h or H, width=w or W, batch_size=b or B,
                   compute_dtype=dtype, **options)


def smoke_noise(gen, cfg, b, h, w):
    """Automask tie-break noise of ``cfg`` on the CPU: {scale: (b, h, w,
    sources)}, at each scale's own size under v1_multiscale; None without
    automasking."""
    import torch

    if cfg.disable_automasking:
        return None
    sources = len(cfg.frame_ids) - 1 + cfg.use_stereo
    multi = cfg.v1_multiscale
    return {s: torch.randn((b, h >> s if multi else h, w >> s if multi else w,
                            sources), generator=gen) * 1e-5
            for s in cfg.scales}


def to_device(noise, device):
    return None if noise is None else {s: n.to(device)
                                       for s, n in noise.items()}


# bfloat16 on the card against bfloat16 on the CPU: both round every layer
# once to bfloat16, cuDNN and the CPU's convolutions in their own orders, so
# they are held to the CPU's own bfloat16-against-float32 gap on the same
# weights and inputs: the largest difference within BF16_MAX times the
# gap's largest, the mean within BF16_MEAN times the gap's mean (the CPU
# tests hold the port's bfloat16 to the JAX package's in the same way,
# tests/test_torch_bf16_models.py); each loss within BF16_LOSS times the
# largest gap of the losses plus this script's float32 bound (1e-4 of its
# value); the whole gradient in L2 within BF16_MEAN times the gap's.
BF16_MAX, BF16_MEAN, BF16_LOSS = 3.0, 2.0, 4.0
# the GAN generator's float32 output (tanh) on the card against the CPU's:
# the bound tests/test_torch_gan_models.py holds it to against the JAX
# package's
GAN_ATOL = 2e-4


def within_bf16_gap(card, cpu, cpu_f32, what):
    """Hold ``card`` (any device) to ``cpu`` by the gap between ``cpu`` and
    ``cpu_f32``: BF16_MAX on the largest difference, BF16_MEAN on the
    mean; -> the two ratios."""
    card = card.detach().cpu().double()
    cpu, cpu_f32 = cpu.detach().double(), cpu_f32.detach().double()
    gap, err = (cpu - cpu_f32).abs(), (card - cpu).abs()
    if not float(gap.max()) > 0:
        raise AssertionError(f"{what}: no bfloat16 gap on the CPU")
    ratios = (float(err.max() / gap.max()), float(err.mean() / gap.mean()))
    print(f"  bf16 {what}, card vs CPU: max {float(err.max()):.3e} = "
          f"{ratios[0]:.2f}x the CPU's bf16-float32 gap (tol {BF16_MAX}), "
          f"mean {ratios[1]:.2f}x (tol {BF16_MEAN})", flush=True)
    if not (ratios[0] <= BF16_MAX and ratios[1] <= BF16_MEAN):
        raise AssertionError(f"bf16 {what} on the card disagrees with the "
                             f"CPU")
    return ratios


def bf16_losses_close(card, cpu, cpu_f32, what):
    """Each loss of ``card`` within BF16_LOSS times the largest CPU gap of
    the losses plus 1e-4 of its value; -> the worst share of the bound."""
    keys = [k for k in cpu if k != "grad_norm"]
    gap = max(abs(float(cpu[k]) - float(cpu_f32[k])) for k in keys)
    worst = max(abs(float(card[k]) - float(cpu[k]))
                / (BF16_LOSS * gap + 1e-4 * abs(float(cpu[k]))) for k in keys)
    print(f"  bf16 {what} losses, card vs CPU: worst {worst:.3f} of the "
          f"bound ({BF16_LOSS}x the CPU's largest bf16-float32 gap "
          f"{gap:.3e}, plus 1e-4 relative)", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"bf16 {what} losses on the card disagree "
                             f"with the CPU")
    return worst


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


def small_bundles(device, b, h, w, options=None):
    """The bundle of seed 3 (with ``options``) at B=b, h x w on the CPU in
    float32 and in bfloat16 (the same weights) and a copy of the bfloat16
    one on ``device``."""
    import copy

    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle

    cpu32, cpu16 = (ModelBundle.create(smoke_options(b, h, w, dt,
                                                     **(options or {})),
                                       seed=3, device="cpu")
                    for dt in ("float32", "bfloat16"))
    return cpu32, cpu16, copy.deepcopy(cpu16).to(device)


def check_bf16_against_cpu(device):
    """check_against_cpu at bfloat16: the validation step in both modes and
    the inference step on the card against the CPU's, on the same weights,
    inputs and automask noise at B=2, 64x128, held to the CPU's own
    bfloat16-against-float32 gap (BF16_*)."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.train.step import (
        build_eval_step, build_infer_step)

    b, h, w = 2, 64, 128
    cpu32, cpu16, card = small_bundles(device, b, h, w)
    gen = torch.Generator().manual_seed(4)
    batch = smoke_batch(gen, "cpu", b, h, w)
    noise = {s: torch.randn((b, h, w, 2), generator=gen) * 1e-5
             for s in range(4)}
    for with_images in (False, True):
        want, ref = (build_eval_step(x, with_images)(batch, noise=noise)[0]
                     for x in (cpu16, cpu32))
        got = build_eval_step(card, with_images)(
            {k: v.to(device) for k, v in batch.items()},
            noise={s: n.to(device) for s, n in noise.items()})[0]
        bf16_losses_close(got, want, ref,
                          f"validation (with_images={with_images})")
    images = batch["color"][:, 0].float() / 255.0
    want, ref = (build_infer_step(x)(images)[0] for x in (cpu16, cpu32))
    got = build_infer_step(card)(images.to(device))[0]
    if got.dtype != torch.float32:
        raise AssertionError(f"bf16 disparity came back {got.dtype}")
    within_bf16_gap(got, want, ref, f"disparity at B={b}, {w}x{h}")


def phase_eval_step(device="cuda", dtype="float32"):
    """The validation step in both modes; asserts finite losses and the
    kernel launches of each mode; -> launches of the whole phase."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle
    from unsupervised_pose_estimation_tpu_torch.train.step import \
        build_eval_step

    if dtype == "float32":
        check_against_cpu(device)
    else:
        check_bf16_against_cpu(device)
    opt = smoke_options(dtype=dtype)
    bundle = ModelBundle.create(opt, seed=0, device=device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
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
    if device == "cuda":
        print(f"  {dtype}: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"{card_line()}", flush=True)
    return total


# jitter factors [enabled, brightness, contrast, saturation, hue,
# autocontrast] of the training batches, cycled over the items
AUG_ROWS = [[1.0, 1.1, 0.9, 1.15, 0.05, 1.0], [1.0, 0.9, 1.1, 0.85, -0.04, 0.0],
            [0.0, 1.0, 1.0, 1.0, 0.0, 0.0]]
LR = 1e-4


def train_batch(gen, device, b=None, h=None, w=None, stereo=False):
    """A training batch: smoke_batch's frames and intrinsics, and per-item
    jitter factors (aug_params) in place of color_aug."""
    import torch

    batch = smoke_batch(gen, device, b, h, w, stereo)
    del batch["color_aug"]
    n = batch["color"].shape[0]
    rows = torch.tensor(AUG_ROWS, dtype=torch.float32)
    batch["aug_params"] = rows[torch.arange(n) % len(AUG_ROWS)].to(device)
    return batch


def check_train_against_cpu(device, version=8, steps=2, networks=True,
                            options=None):
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
    ``networks`` whether the float64 network check follows, ``options``
    more Options fields (a training option group, phase 9)."""
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
    opt = smoke_options(b, h, w, **(options or {}))
    opt.pallas_warp_version = version
    cpu = ModelBundle.create(opt, seed=3, device="cpu")
    card = copy.deepcopy(cpu).to(device)
    runs = [(x, create_train_state(x), build_train_step(x))
            for x in (cpu, card)]
    gen = torch.Generator().manual_seed(5)
    batch = train_batch(gen, "cpu", b, h, w, opt.use_stereo)
    aug_err = float((batch_augment(batch["color"].to(device),
                                   batch["aug_params"].to(device)).cpu()
                     - batch_augment(batch["color"], batch["aug_params"])
                     ).abs().max())
    print(f"  augmentation, card vs CPU: max abs error {aug_err:.3e} "
          f"(tol 0)", flush=True)
    if aug_err != 0.0:
        raise AssertionError("batch_augment on the card differs from the "
                             "CPU")
    names = [n for n, _ in cpu.named_main_parameters()]
    label = f" {json.dumps(options)}" if options else ""
    for k in range(steps):
        card.load_state_dict(cpu.state_dict())
        noise = smoke_noise(gen, opt, b, h, w)
        want = runs[0][2](runs[0][1], batch, noise=noise)
        got = runs[1][2](runs[1][1], {n: v.to(device)
                                      for n, v in batch.items()},
                         noise=to_device(noise, device))
        rel = {n: abs(float(got[n]) - float(v)) / abs(float(v))
               for n, v in want.items()}
        worst = max((n for n in rel if n != "grad_norm"), key=rel.get)
        card_grads = dict(card.named_main_parameters())
        grad_l2 = math.sqrt(sum(
            float(((card_grads[n].grad.cpu() - p.grad).double() ** 2).sum())
            for n, p in cpu.named_main_parameters()) / sum(
            float((p.grad.double() ** 2).sum())
            for p in cpu.main_parameters()))
        cpu_sd, card_sd = cpu.state_dict(), card.state_dict()
        diff = torch.cat([(card_sd[n].cpu() - cpu_sd[n]).abs().flatten()
                          for n in names])
        stats = max(float((card_sd[n].cpu() - cpu_sd[n]).abs().max())
                    for n in cpu_sd if "running" in n)
        norm_tol = 1e-4 if k == 0 else 1e-3
        print(f"  card vs CPU, version {version}{label}, step {k + 1}: "
              f"losses "
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
        if opt.adversarial_prior:
            check_disc_step_against_cpu(cpu, card, runs[0][1], runs[1][1],
                                        batch, k + 1)
    if networks:
        check_networks_float64(cpu, device, batch_augment(
            batch["color"], batch["aug_params"]))


def gan_inputs(batch):
    """The un-augmented target frame of ``batch`` as float and its grey
    (NCHW), the generator's input."""
    from unsupervised_pose_estimation_tpu_torch.train.step import (
        _f32, _grayscale, _nchw)

    color0 = _f32(batch["color"][:, 0])
    return color0, _nchw(_grayscale(color0))


def check_disc_step_against_cpu(cpu, card, cpu_state, card_state, batch,
                                step):
    """After training step ``step`` of check_train_against_cpu: the
    generator's output (tanh) on the card within GAN_ATOL of the CPU's;
    then one discriminator step on each side from the same discriminator
    and Adam moments, both on the CPU's real samples (the generator's
    disparities, 1 / (1 + 1e5 t) of its output t: where t is near 0 that
    multiplies rounding by up to 1e5, so cuDNN's and the CPU's own samples
    are not compared through the discriminator); the disc loss within
    1e-4 relative; after the update the discriminator within twice the
    CPU's largest update plus 1e-6 (an element whose gradient is within
    rounding of 0 can move either way; Adam's first update is lr times
    the gradient's sign, a later one with b1 0.5 can exceed lr: the CPU's
    largest was 1.054 lr at step 2)."""
    import copy

    import torch

    from unsupervised_pose_estimation_tpu_torch.train.step import (
        build_disc_step, gan_prior)

    device = next(card.parameters()).device
    card_batch = {k: v.to(device) for k, v in batch.items()}
    color0, gray = gan_inputs(batch)
    with torch.no_grad():
        tanh_err = float((card.generator(gray.to(device)).cpu()
                          - cpu.generator(gray)).abs().max())
    real = gan_prior(cpu, color0)
    card.discriminator.load_state_dict(cpu.discriminator.state_dict())
    # a copy: on the CPU load_state_dict would share the moment tensors
    card_state.disc_optimizer.load_state_dict(
        copy.deepcopy(cpu_state.disc_optimizer.state_dict()))
    before = {n: v.clone() for n, v in cpu.discriminator.state_dict().items()}
    want = build_disc_step(cpu)(cpu_state, batch, real=real)
    got = build_disc_step(card)(card_state, card_batch,
                                real=real.to(device))
    rel = abs(float(got["disc_loss"]) - float(want["disc_loss"])) / abs(
        float(want["disc_loss"]))
    lr = cpu.cfg.discriminator_lr
    cpu_sd, card_sd = (x.discriminator.state_dict() for x in (cpu, card))
    moved = max(float((card_sd[n].cpu() - v).abs().max())
                for n, v in cpu_sd.items())
    update = max(float((v - before[n]).abs().max())
                 for n, v in cpu_sd.items())
    print(f"  disc step {step}, card vs CPU: generator output max abs "
          f"error {tanh_err:.3e} (tol {GAN_ATOL:g}); disc_loss "
          f"{float(want['disc_loss']):.6f}, relative error {rel:.3e} (tol "
          f"1e-4); discriminator after its Adam {moved / lr:.3f} lr apart "
          f"(tol 2x the CPU's largest update, {update / lr:.3f} lr)",
          flush=True)
    if not (tanh_err <= GAN_ATOL and rel <= 1e-4
            and moved <= 2 * update + 1e-6):
        raise AssertionError(f"disc step {step} on the card disagrees with "
                             f"the CPU")


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
        grads.append({n: p.grad.cpu()
                      for n, p in net.named_main_parameters()})
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


def bf16_gradient_checks(card, cpu, cpu_f32):
    """The bfloat16 gradient ``card`` against ``cpu`` ({name: tensor}), by
    the CPU's own bfloat16-against-float32 gap (``cpu`` against
    ``cpu_f32``), as tests/test_torch_bf16_step.py holds the port's to the
    JAX package's: the whole gradient in L2 within BF16_MEAN times the gap,
    and per network the scale (the median over its parameters of the
    least-squares factor <card, cpu> / <cpu, cpu>) no further from 1 than
    BF16_MEAN times the CPU float32's largest distance over the networks
    (a network's gradient halved or doubled fails it); -> failures."""
    def dot(a, b):
        return float((a.double() * b.double()).sum())

    names = list(cpu)
    gap = math.sqrt(sum(dot(cpu[n] - cpu_f32[n], cpu[n] - cpu_f32[n])
                        for n in names))
    err = math.sqrt(sum(dot(card[n] - cpu[n], card[n] - cpu[n])
                        for n in names))
    norm = math.sqrt(sum(dot(cpu_f32[n], cpu_f32[n]) for n in names))

    def scale(g, net):
        return statistics.median(dot(g[n], cpu[n]) / dot(cpu[n], cpu[n])
                                 for n in names if n.startswith(net))

    nets = [net for net in ("encoder.", "depth.", "pose_encoder.", "pose.",
                            "predictive_mask.")
            if any(n.startswith(net) for n in names)]
    ref_dev = max(abs(scale(cpu_f32, net) - 1.0) for net in nets)
    devs = {net: abs(scale(card, net) - 1.0) for net in nets}
    print(f"  bf16 gradient, card vs CPU: L2 {err:.3e} = {err / gap:.2f}x "
          f"the CPU's bf16-float32 gap {gap:.3e} ({gap / norm:.2f} of "
          f"the float32 gradient's norm; tol {BF16_MEAN}x); per-network "
          f"scale's distance from 1 "
          f"{[round(d, 4) for d in devs.values()]} against the CPU "
          f"float32's largest {ref_dev:.4f} (tol {BF16_MEAN}x)", flush=True)
    failed = [] if err <= BF16_MEAN * gap else ["L2"]
    return failed + [net for net, d in devs.items()
                     if not d <= BF16_MEAN * ref_dev]


def check_bf16_train_against_cpu(device, options=None):
    """One bfloat16 training step on the card against the CPU's, from the
    same weights (seed 3), batch, augmentation and automask noise at B=2,
    64x128, each with its own Adam: the losses and the gradient held to the
    CPU's own bfloat16-against-float32 gap (BF16_*, bf16_gradient_checks);
    the share of parameters whose Adam update has the other sign than the
    CPU's within BF16_MEAN times the share between the CPU's bfloat16 and
    float32 updates; the BatchNorm statistics within BF16_MAX times the
    CPU's gap; parameters, gradients and Adam's moments float32.
    ``options``: more Options fields (a training option group, phase
    9)."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.train.state import \
        create_train_state
    from unsupervised_pose_estimation_tpu_torch.train.step import \
        build_train_step

    b, h, w = 2, 64, 128
    nets = small_bundles(device, b, h, w, options)
    cfg = nets[0].cfg
    gen = torch.Generator().manual_seed(5)
    batch = train_batch(gen, "cpu", b, h, w, cfg.use_stereo)
    noise = smoke_noise(gen, cfg, b, h, w)
    init = {n: p.detach().clone()
            for n, p in nets[0].named_main_parameters()}
    out, states = [], []
    for net in nets:
        dev = next(net.parameters()).device
        state = create_train_state(net)
        states.append(state)
        losses = build_train_step(net)(
            state, {k: v.to(dev) for k, v in batch.items()},
            noise=to_device(noise, dev))
        moments = [t for st in state.optimizer.state.values()
                   for t in st.values() if torch.is_tensor(t)]
        if any(t.dtype != torch.float32 for t in [
                *net.parameters(), *moments,
                *(p.grad for p in net.main_parameters())]
               if t.is_floating_point()):
            raise AssertionError("a parameter, gradient or Adam moment of "
                                 "the bf16 step is not float32")
        out.append((losses, {n: p.grad.detach().cpu()
                             for n, p in net.named_main_parameters()},
                    {n: t.detach().cpu()
                     for n, t in net.state_dict().items()}))
    (ref, g32, sd32), (want, g16, sd16), (got, gcard, sdcard) = out
    bf16_losses_close(got, want, ref, "training step")
    failed = bf16_gradient_checks(gcard, g16, g32)

    def flipped(sd_a, sd_b):
        """The share of parameters whose updates differ in sign."""
        return sum(int((torch.sign(sd_a[n] - init[n])
                        != torch.sign(sd_b[n] - init[n])).sum())
                   for n in init) / sum(t.numel() for t in init.values())

    signs = flipped(sdcard, sd16), flipped(sd16, sd32)
    stats = [n for n in sd16 if "running" in n]
    stat_gap = max(float((sd16[n] - sd32[n]).abs().max()) for n in stats)
    stat_err = max(float((sdcard[n] - sd16[n]).abs().max()) for n in stats)
    print(f"  bf16 Adam updates, card vs CPU: {signs[0]:.4%} of the "
          f"parameters moved the other way, against {signs[1]:.4%} between "
          f"the CPU's bf16 and float32 (tol {BF16_MEAN}x); statistics "
          f"{stat_err:.3e} = {stat_err / stat_gap:.2f}x the CPU's gap (tol "
          f"{BF16_MAX})", flush=True)
    if failed or not (signs[0] <= BF16_MEAN * signs[1]
                      and stat_err <= BF16_MAX * stat_gap):
        raise AssertionError(f"the bf16 training step on the card disagrees "
                             f"with the CPU: {failed}")
    if cfg.adversarial_prior:
        check_bf16_disc_step(nets, states, batch)


def check_bf16_disc_step(nets, states, batch):
    """After check_bf16_train_against_cpu's step: the bfloat16 generator's
    output on the card held to the CPU's bfloat16-against-float32 gap;
    one discriminator step on each of (CPU float32, CPU bfloat16, card
    bfloat16), all on the float32 CPU's real samples (as
    check_disc_step_against_cpu): the disc loss by bf16_losses_close, the
    share of the discriminator's parameters whose update has the other
    sign than the CPU bfloat16's within BF16_MEAN times the share between
    the CPU's bfloat16 and float32 updates."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.train.step import (
        build_disc_step, gan_prior)

    color0, gray = gan_inputs(batch)
    with torch.no_grad():
        tanh = [net.generator(gray.to(next(net.parameters()).device))
                for net in nets]
    within_bf16_gap(tanh[2], tanh[1], tanh[0], "generator output")
    real = gan_prior(nets[0], color0)
    init = {n: p.detach().clone()
            for n, p in nets[0].discriminator.named_parameters()}
    losses, after = [], []
    for net, state in zip(nets, states):
        dev = next(net.parameters()).device
        net.discriminator.load_state_dict(init)
        losses.append(build_disc_step(net)(
            state, {k: v.to(dev) for k, v in batch.items()},
            real=real.to(dev)))
        after.append({n: p.detach().cpu()
                      for n, p in net.discriminator.named_parameters()})
    bf16_losses_close(losses[2], losses[1], losses[0], "disc step")
    total = sum(t.numel() for t in init.values())

    def flipped(a, b):
        return sum(int((torch.sign(a[n] - init[n])
                        != torch.sign(b[n] - init[n])).sum())
                   for n in init) / total

    signs = flipped(after[2], after[1]), flipped(after[1], after[0])
    print(f"  bf16 discriminator updates, card vs CPU: {signs[0]:.4%} of "
          f"its parameters moved the other way, against {signs[1]:.4%} "
          f"between the CPU's bf16 and float32 (tol {BF16_MEAN}x)",
          flush=True)
    if not signs[0] <= BF16_MEAN * signs[1]:
        raise AssertionError("the bf16 disc step on the card disagrees with "
                             "the CPU")


def check_step_repeats(bundle, batch):
    """The training step's forward and backward twice from the same
    parameters, batch and noise under the trainer's setting
    (``train.loop.deterministic_cudnn``): the losses and every gradient
    must be the same bits."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.train.loop import \
        deterministic_cudnn
    from unsupervised_pose_estimation_tpu_torch.train.step import \
        forward_and_loss

    noise = to_device(smoke_noise(torch.Generator().manual_seed(9),
                                  bundle.cfg, B, H, W), batch["color"].device)
    runs = []
    with deterministic_cudnn():
        for _ in range(2):
            bundle.zero_grad(set_to_none=True)
            total, (losses, _) = forward_and_loss(bundle, batch, train=True,
                                                  noise=noise)
            total.backward()
            runs.append((losses, {n: p.grad.clone() for n, p in
                                  bundle.named_main_parameters()}))
    (l0, g0), (l1, g1) = runs
    differ = [k for k in l0 if not torch.equal(l0[k], l1[k])] + [
        n for n in g0 if not torch.equal(g0[n], g1[n])]
    bundle.zero_grad(set_to_none=True)
    print(f"  the step twice under deterministic cuDNN: losses and "
          f"{len(g0)} gradients bit-equal: {not differ}", flush=True)
    if differ:
        raise AssertionError(f"a repeated step differs in {differ[:5]}")


def check_reflect_pad_repeats(device, dtype):
    """Why the networks pad with their own backward: torch's reflect-pad
    backward, repeated, differed on every repeat on the H100;
    ``models.layers.reflect_pad1``'s must give the same bits."""
    import torch
    import torch.nn.functional as F

    from unsupervised_pose_estimation_tpu_torch.models.layers import \
        reflect_pad1

    gen = torch.Generator(device).manual_seed(9)
    x = torch.randn((B, 16, H, W), generator=gen, device=device,
                    dtype=getattr(torch, dtype))
    x.requires_grad_()
    padded = F.pad(x, (1, 1, 1, 1), mode="reflect")
    g = torch.randn(padded.shape, generator=gen, device=device,
                    dtype=x.dtype)
    grads = [torch.autograd.grad(padded, x, g, retain_graph=True)[0]
             for _ in range(6)]
    torch_differs = sum(not torch.equal(grads[0], t) for t in grads[1:])
    mine = [torch.autograd.grad(reflect_pad1(x), x, g)[0] for _ in range(6)]
    mine_differs = sum(not torch.equal(mine[0], t) for t in mine[1:])
    print(f"  reflect-pad backward at {tuple(x.shape)}, 5 repeats against "
          f"the first: torch's differed {torch_differs}, reflect_pad1's "
          f"{mine_differs}", flush=True)
    if mine_differs:
        raise AssertionError("reflect_pad1's backward is not repeatable")


DET_ROUNDS, DET_STEPS = 16, 3


def time_deterministic_cudnn(step, state, batch, dtype):
    """Wall ms of the bare step with and without the trainer's
    deterministic cuDNN, in DET_ROUNDS rounds of DET_STEPS steps each way,
    the order alternating (on-off, off-on); -> {"on": [...], "off":
    [...]}."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.train.loop import \
        deterministic_cudnn

    times = {"on": [], "off": []}

    def run(mode):
        with deterministic_cudnn() if mode == "on" else \
                contextlib.nullcontext():
            step(state, batch)  # the algorithm choice of this setting
            torch.cuda.synchronize()
            for _ in range(DET_STEPS):
                start = time.perf_counter()
                step(state, batch)
                torch.cuda.synchronize()
                times[mode].append(1e3 * (time.perf_counter() - start))

    for r in range(DET_ROUNDS):
        for mode in (("on", "off") if r % 2 == 0 else ("off", "on")):
            run(mode)
    rounds = [statistics.median(times["on"][i:i + DET_STEPS])
              - statistics.median(times["off"][i:i + DET_STEPS])
              for i in range(0, len(times["on"]), DET_STEPS)]
    on, off = (statistics.median(times[m]) for m in ("on", "off"))
    print(f"  {dtype} step, deterministic cuDNN on vs off ({DET_ROUNDS} "
          f"alternating rounds of {DET_STEPS}): median {on:.2f} vs "
          f"{off:.2f} ms ({100 * (on / off - 1):+.1f}%); per-round "
          f"difference of medians {[round(d, 2) for d in rounds]} ms "
          f"(median {statistics.median(rounds):+.2f}); {card_line()}",
          flush=True)
    return times


def phase_train_step(device="cuda", dtype="float32"):
    """Three training steps in each warp + loss mode on one bundle; asserts
    finite losses, changed parameters and each step's kernel launches;
    then the trainer's mode: the step repeated bit for bit under
    deterministic cuDNN, and timed with it and without; -> launches of the
    whole phase."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle
    from unsupervised_pose_estimation_tpu_torch.train.state import \
        create_train_state
    from unsupervised_pose_estimation_tpu_torch.train.step import \
        build_train_step

    if dtype == "float32":
        check_train_against_cpu(device)
    else:
        check_bf16_train_against_cpu(device)
    bundle = ModelBundle.create(smoke_options(dtype=dtype), seed=0,
                                device=device)
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
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
                  f"{dtype}; {card_line()}", flush=True)
    bundle.cfg.use_pallas_warp_loss = True  # the trainer's mode
    check_step_repeats(bundle, batch)
    check_reflect_pad_repeats(device, dtype)
    if device == "cuda":
        K.reset_counts()
        time_deterministic_cudnn(step, state, batch, dtype)
        for name, n in K.counts().items():
            total[name] += n
    return total


def check_bf16_serving_against_cpu(device):
    """An InferenceEngine at bfloat16 on the card against one on the CPU
    with the same weights (seed 3) on the same 4 images at 64x128, held to
    the CPU's own bfloat16-against-float32 gap (BF16_*)."""
    import numpy as np
    import torch

    from unsupervised_pose_estimation_tpu_torch.serve import InferenceEngine

    b, h, w = 4, 64, 128
    cpu32, cpu16, card = small_bundles(device, b, h, w)
    images = np.random.default_rng(7).integers(0, 256, (b, h, w, 3),
                                               dtype=np.uint8)
    ref, want, got = (
        InferenceEngine(net.cfg, max_batch=b, bundle=net,
                        device=next(net.parameters()).device).predict(images)
        for net in (cpu32, cpu16, card))
    if got.dtype != np.float32:
        raise AssertionError(f"bf16 serving returned {got.dtype}")
    within_bf16_gap(*(torch.from_numpy(x) for x in (got, want, ref)),
                    "served disparity")


def phase_serve(device="cuda", dtype="float32"):
    """16 requests from 4 threads through MicroBatcher -> InferenceEngine
    at ``dtype`` (at bfloat16 after a check of the engine against the
    CPU's)."""
    import numpy as np
    import torch

    from unsupervised_pose_estimation_tpu_torch.serve import (InferenceEngine,
                                                               MicroBatcher)

    if dtype != "float32":
        check_bf16_serving_against_cpu(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    engine = InferenceEngine(smoke_options(dtype=dtype), max_batch=8,
                             device=device)
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
    seconds = time.perf_counter() - start
    print(f"  16 requests answered, {engine.calls} engine calls, disp range "
          f"[{min(float(d.min()) for d in results):.4f}, "
          f"{max(float(d.max()) for d in results):.4f}]", flush=True)
    if device == "cuda":
        from unsupervised_pose_estimation_tpu_torch.ops import kernels as K

        print(f"  {dtype}: {1e3 * seconds:.1f} wall ms for the 16 requests "
              f"(engine construction and the first calls included); peak "
              f"device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"launches {K.counts()} (serving runs no kernel of the "
              f"port's); {card_line()}", flush=True)


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


# The trainer phase: the port's training entry point at the flagship feed.
TRAIN_ARGS = ["--weights_init", "scratch",
              "--num_epochs", "1", "--log_frequency", "3",
              "--ckpt_frequency", "3", "--num_workers", "8"]
PARALLAX_ARGS = ["--dataset", "synthetic_parallax", "--steps_per_epoch", "6"]
# Resumed against the uninterrupted run: the restored parameters, Adam
# moments, batches and noise are bit-equal, and the trainer's steps are
# deterministic (cuDNN's deterministic algorithms while it trains,
# train.loop.deterministic_cudnn, and the networks' own reflect-pad
# backward, models.layers.reflect_pad1), so every resumed step's losses
# and gradient norm must be the same bits. (With torch's reflect-pad
# backward, which adds with atomics, and cuDNN free to choose, resumed steps
# differed in the last bits.)
RESUME_LOSS_RTOL = 0.0
RESUME_NORM_RTOL = 0.0
LUNG_LINES = 30  # lines per split file of the frame-cache route


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except FileNotFoundError:
        return "nvidia-smi not found"
    return smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}"


def recording_steps(loop, seen):
    """Make the trainer's step record (state.step, device copy of the
    batch, losses, host time at entry) of every step it takes; -> the
    function that undoes it."""
    real = loop.build_train_step

    def build(bundle, *args, **kwargs):
        step = real(bundle, *args, **kwargs)

        def run(state, batch):
            entry = (state.step, {k: v.clone() for k, v in batch.items()},
                     time.perf_counter())
            losses = step(state, batch)
            seen.append(entry + ({k: v.detach().clone()
                                  for k, v in losses.items()},))
            return losses
        return run

    loop.build_train_step = build
    return lambda: setattr(loop, "build_train_step", real)


def check_batches_against_host(seen, loader, epoch=0):
    """Each batch a step consumed equals the host's collate of the items
    the loader's shuffle names for it (a copy raced by the next batch
    would not)."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.data.pipeline import collate

    rows = loader._indices(epoch)
    for step, batch, _, _ in seen:
        host = collate([loader.dataset.get_item(int(i), epoch)
                        for i in rows[step % len(rows)]])
        for key, value in host.items():
            if not torch.equal(batch[key].cpu(), torch.from_numpy(value)):
                raise AssertionError(f"step {step}: batch['{key}'] differs "
                                     f"from the host's items")


def write_lung_cache(root, h, w):
    """A lung-style split (30 train and 30 val lines of one sequence) and
    a frame cache of every frame they reach, written with numpy in the
    format data/cache.py reads; -> the split_dir, data_path and cache
    arguments."""
    import json as _json
    import os

    import numpy as np

    from unsupervised_pose_estimation_tpu_torch.data.cache import (
        FRAMES_FILE, INDEX_FILE, dataset_fingerprint, enumerate_frames,
        frame_key)
    from unsupervised_pose_estimation_tpu_torch.data.datasets import \
        LungRAWDataset

    data_path = os.path.join(root, "lung_data")  # holds no image file
    os.makedirs(data_path)
    rng = np.random.default_rng(12)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for mode, first in (("train", 1), ("val", 101)):
        lines = [f"seq1 {i} l" for i in range(first, first + LUNG_LINES)]
        os.makedirs(os.path.join(root, "splits", "lung_smoke"),
                    exist_ok=True)
        with open(os.path.join(root, "splits", "lung_smoke",
                               f"{mode}_files.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        ds = LungRAWDataset(data_path, lines, h, w, [0, -1, 1])
        keys = enumerate_frames(ds)
        frames = np.empty((len(keys), h, w, 3), np.uint8)
        for row, (_, fi, _) in enumerate(keys):
            # a smooth texture sliding 2 px a frame
            phase = rng.uniform(0, 6.3, 3)
            for c in range(3):
                frames[row, ..., c] = 127.5 + 127 * np.sin(
                    0.05 * (xs + 2 * fi) + 0.03 * ys * (c + 1) + phase[c])
        out = os.path.join(root, "cache", mode)
        os.makedirs(out)
        np.save(os.path.join(out, FRAMES_FILE), frames)
        with open(os.path.join(out, INDEX_FILE), "w") as f:
            _json.dump({"height": h, "width": w, "rows": len(keys),
                        "fingerprint": dataset_fingerprint(ds),
                        "index": {frame_key(*k): r
                                  for r, k in enumerate(keys)}}, f)
    return ["--split", "lung_smoke", "--split_dir",
            os.path.join(root, "splits"), "--data_path", data_path,
            "--frame_cache", os.path.join(root, "cache")]


@phase("trainer")
def phase_trainer(device="cuda", keep_checkpoints=None):
    """The port's cli.train.main at batch B, H x W at the defaults
    (bfloat16): six steps with logs, validation and checkpoints at steps 3
    and 6; a second Trainer resumed from the checkpoint of step 3; two
    steps of the lung dataset from a frame cache. The main run's
    checkpoint directory is copied to ``keep_checkpoints`` when given.
    -> kernel launches of the phase."""
    import json as _json
    import os
    import shutil
    import tempfile

    import torch

    from unsupervised_pose_estimation_tpu_torch.cli.train import main as train
    from unsupervised_pose_estimation_tpu_torch.config import parse_options
    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.train import loop

    args = TRAIN_ARGS + ["--batch_size", str(B), "--height", str(H),
                         "--width", str(W)]
    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    main_run, resumed_run, file_run = [], [], []
    try:
        undo = recording_steps(loop, main_run)
        K.reset_counts()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        try:
            trainer = train(args + PARALLAX_ARGS + [
                "--log_dir", os.path.join(root, "main")], device=device)
        finally:
            undo()
        wall = time.perf_counter() - start
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device == "cuda" else float("nan"))
        loader = trainer.train_loader
        check_batches_against_host(main_run, loader)
        entries = [t for _, _, t, _ in main_run]
        gaps = [1e3 * (b - a) for a, b in zip(entries, entries[1:])]
        # steady steps: the first includes cuDNN's algorithm choice
        frames_per_s = B * (len(entries) - 2) / (entries[-1] - entries[1])
        with open(os.path.join(root, "main", "mdp", "metrics.jsonl")) as f:
            records = [_json.loads(line) for line in f]
        if [(r["mode"], r["step"]) for r in records] != [
                ("train", 0), ("val", 0), ("train", 3), ("val", 3)]:
            raise AssertionError(f"metrics.jsonl records {records}")
        bad = [(r["mode"], k) for r in records for k, v in r.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad or "de/abs_rel" not in records[1]:
            raise AssertionError(f"bad or missing metrics: {bad}")
        print(f"  {card_line()}; TF32 matmul "
              f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
              f"{torch.backends.cudnn.allow_tf32}; cuDNN deterministic "
              f"after train() {torch.backends.cudnn.deterministic} "
              f"(restored)", flush=True)
        if torch.backends.cudnn.deterministic:
            raise AssertionError("train() left cuDNN deterministic on")
        print(f"  main run: {len(main_run)} steps at batch {B}, {H}x{W} in "
              f"{wall:.2f} s (construction, 2 validations and 2 "
              f"checkpoints included); wall ms between step starts "
              f"{[round(g, 1) for g in gaps]}; {frames_per_s:.2f} frames/s "
              f"from the start of step 1 to that of step {len(entries) - 1}; "
              f"loader wait "
              f"{1e3 * loader.wait_seconds:.1f} ms over {loader.batches} "
              f"batches ({1e3 * loader.wait_seconds / loader.batches:.1f} "
              f"ms a step); peak device memory {peak:.3f} GiB; val "
              f"de/abs_rel {records[3]['de/abs_rel']:.4f}", flush=True)

        # resume from the checkpoint of step 3 -----------------------
        ckpt = os.path.join(root, "main", "mdp", "models", "checkpoints")
        if keep_checkpoints is not None:
            shutil.copytree(ckpt, keep_checkpoints)
        resume_from = os.path.join(root, "resume_from")
        os.makedirs(resume_from)
        shutil.copy(os.path.join(ckpt, "3.pt"), resume_from)
        undo = recording_steps(loop, resumed_run)
        try:
            resumed = loop.Trainer(parse_options(args + PARALLAX_ARGS + [
                "--log_dir", os.path.join(root, "resumed"),
                "--load_weights_folder", resume_from]), device=device)
            if resumed.state.step != 3:
                raise AssertionError(f"resumed at step {resumed.state.step}")
            saved = torch.load(os.path.join(resume_from, "3.pt"),
                               map_location="cpu", weights_only=True)
            for key, value in resumed.bundle.state_dict().items():
                if not torch.equal(value.cpu(), saved["bundle"][key]):
                    raise AssertionError(f"restored {key} differs")
            moments = resumed.state.optimizer.state_dict()["state"]
            for i, ref in saved["optimizer"]["state"].items():
                for key, value in ref.items():
                    if not torch.equal(moments[i][key].cpu(), value):
                        raise AssertionError(f"restored Adam {key} of "
                                             f"parameter {i} differs")
            resumed.train()
        finally:
            undo()
        tail = main_run[3:]
        taken = ([s for s, *_ in resumed_run], [s for s, *_ in tail])
        if not taken[0] == taken[1] == [3, 4, 5]:
            raise AssertionError(f"steps taken (resumed, straight): {taken}")
        rel_by_step = []
        for (step, batch, _, losses), (_, ref, _, ref_losses) in zip(
                resumed_run, tail):
            for key in batch:
                if not torch.equal(batch[key], ref[key]):
                    raise AssertionError(f"step {step}: batch['{key}'] "
                                         f"differs after the resume")
            rel = {k: abs(float(v) - float(ref_losses[k])) / max(
                abs(float(ref_losses[k])), 1e-12) for k, v in losses.items()}
            rel_by_step.append(rel)
        losses_rel = [max(v for k, v in r.items() if k != "grad_norm")
                      for r in rel_by_step]
        norms_rel = [r["grad_norm"] for r in rel_by_step]
        print(f"  resume at step 3: parameters and Adam moments bit-equal to "
              f"the saved ones, batches of steps 4-6 bit-equal; by step, "
              f"losses' worst relative error {['%.3g' % v for v in losses_rel]}"
              f" (bound {RESUME_LOSS_RTOL}), grad_norm's "
              f"{['%.3g' % v for v in norms_rel]} (bound {RESUME_NORM_RTOL})",
              flush=True)
        if max(losses_rel) > RESUME_LOSS_RTOL or \
                max(norms_rel) > RESUME_NORM_RTOL:
            raise AssertionError(f"resumed losses off: {rel_by_step}")

        # the file route: lung frames from a frame cache, no PIL -----
        undo = recording_steps(loop, file_run)
        try:
            lung = train(args + write_lung_cache(root, H, W) + [
                "--dataset", "endovis", "--steps_per_epoch", "2",
                "--log_dir", os.path.join(root, "lung")], device=device)
        finally:
            undo()
        check_batches_against_host(file_run, lung.train_loader)
        if len(file_run) != 2 or "aug_params" not in file_run[0][1]:
            raise AssertionError("the frame-cache route did not train")
        print(f"  frame-cache route: {len(file_run)} steps of "
              f"LungRAWDataset, loss "
              f"{float(file_run[-1][3]['loss']):.6f}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = K.counts()
    steps = len(main_run) + len(resumed_run) + len(file_run)
    print(f"  {steps} training steps; launches {launches}", flush=True)
    if device == "cuda":
        missing = [k for k in ("warp_reproj_loss", "warp_reproj_loss_bwd",
                               "reproj_loss") if launches[k] == 0]
        if missing or launches["warp_reproj_loss_bwd"] != 8 * steps:
            raise AssertionError(f"trainer launches {launches}")
    return launches



# The evaluation phase: the trainer's checkpoint through both evaluation
# entry points, at the trainer's feed (two batches of B and a tail of 3
# that drop_last cuts) and, against the CPU, at EVAL_SMALL.
EVAL_ITEMS = 2 * B + 3
EVAL_SMALL = (4, 64, 128, 11)  # batch, height, width, items


def eval_args(ckpt, split_dir, b, h, w):
    return ["--load_weights_folder", ckpt, "--height", str(h), "--width",
            str(w), "--batch_size", str(b), "--dataset",
            "synthetic_parallax", "--synthetic_rotation", "--split_dir",
            split_dir, "--eval_split", "smoke"]


def evaluate_both(args, device):
    """cli.evaluate_depth (mono, post_process) and cli.evaluate_pose (no
    plot: the card's machine has no matplotlib); -> both rows."""
    from unsupervised_pose_estimation_tpu_torch.cli import (evaluate_depth,
                                                            evaluate_pose)

    depth = evaluate_depth.main(args + ["--eval_mono", "--post_process"],
                                device=device)
    pose = evaluate_pose.main(args + ["--eval_pose_trajectory"],
                              device=device)
    return {**depth, **pose}


def write_split(root, h, w, n):
    """A synthetic_parallax eval split of ``n`` items with exact depth and
    poses under ``root``; -> its split_dir."""
    from unsupervised_pose_estimation_tpu_torch.config import Options
    from unsupervised_pose_estimation_tpu_torch.eval.evaluate_depth import \
        write_synthetic_split

    split_dir = os.path.join(root, f"splits_{h}x{w}")
    write_synthetic_split(Options(height=h, width=w, split_dir=split_dir,
                                  eval_split="smoke",
                                  synthetic_rotation=True), n)
    return split_dir


@phase("evaluation")
def phase_evaluation(ckpt, device="cuda"):
    """cli.evaluate_depth and cli.evaluate_pose on the trainer's checkpoint
    at the defaults (bfloat16): on the card at B, H x W, timed; then at
    EVAL_SMALL on the card and on the CPU, the disparities (post-processed,
    with the one-frame tail) and the poses held to the CPU's own
    bfloat16-against-float32 gap (BF16_*), and each metric within
    BF16_LOSS times the row's largest relative bf16-float32 gap on the CPU
    plus 1e-4 of its value."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.config import parse_options
    from unsupervised_pose_estimation_tpu_torch.eval import evaluate_depth as ED
    from unsupervised_pose_estimation_tpu_torch.eval import evaluate_pose as EP
    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K

    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        split_dir = write_split(root, H, W, EVAL_ITEMS)
        K.reset_counts()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        row = evaluate_both(eval_args(ckpt, split_dir, B, H, W), device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - start
        bad = [k for k, v in row.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite metrics {bad}")
        print(f"  {EVAL_ITEMS} items at batch {B}, {W}x{H}, bfloat16: "
              f"{1e3 * wall:.1f} wall ms for both entry points (item "
              f"rendering included); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"launches {K.counts()}; {card_line()}", flush=True)
        print(f"  row: {json.dumps(row)}", flush=True)

        b, h, w, n = EVAL_SMALL
        args = eval_args(ckpt, write_split(root, h, w, n), b, h, w)
        files = [f"synthetic {i} l" for i in range(n)]
        disps, poses = [], []
        for dev, dtype in ((device, "bfloat16"), ("cpu", "bfloat16"),
                           ("cpu", "float32")):
            opt = parse_options(args + ["--post_process", "--compute_dtype",
                                        dtype])
            disps.append(torch.from_numpy(ED.predict_disparities(
                opt, ED.load_eval_state(opt, dev), files)))
            poses.append(torch.from_numpy(EP.predict_pose_sequence(
                opt, ED.load_eval_state(opt, dev, ("pose_encoder", "pose")),
                files)))
        within_bf16_gap(*disps, f"evaluation disparities ({n} items at "
                                f"batch {b}, {w}x{h}, post-processed)")
        within_bf16_gap(*poses, "evaluation poses")
        rows = [evaluate_both(args, device), evaluate_both(args, "cpu"),
                evaluate_both(args + ["--compute_dtype", "float32"], "cpu")]
        rel = [{k: abs(r[k] - rows[1][k]) / abs(rows[1][k])
                for k in rows[1]} for r in (rows[0], rows[2])]
        gap = max(rel[1].values())
        worst = max(rel[0][k] / (BF16_LOSS * gap + 1e-4) for k in rel[0])
        print(f"  metric rows, card vs CPU at bfloat16: worst "
              f"{worst:.3f} of the bound ({BF16_LOSS}x the CPU row's "
              f"largest relative bf16-float32 gap {gap:.3e}, plus 1e-4); "
              f"card {json.dumps(rows[0])}", flush=True)
        if not worst <= 1.0:
            raise AssertionError("evaluation on the card disagrees with the "
                                 "CPU")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The options phase: the training options beyond the defaults, one group
# per tests/test_torch_options_*.py file.
OPTION_GROUPS = {
    "A": dict(pose_model_type="shared", use_stereo=True, v1_multiscale=True),
    "B": dict(pose_model_type="posecnn", pose_model_input="all",
              predictive_mask=True, disable_automasking=True,
              depth_decoder_variant="upstream"),
    "C": dict(pose_model_input="all"),
}
OPTION_TRAIN_ARGS = ["--pose_model_type", "posecnn", "--pose_model_input",
                     "all", "--v1_multiscale", "--depth_decoder_variant",
                     "upstream"]
K6_RUNGS = ("v1", "v2", "v3", "v4", "v5", "v3_wide")


def option_launches(cfg, train):
    """The kernel launches of one step of ``cfg`` at B, H x W (version 8)
    apart from K6's, which depend on the data: the fused K1 (and K2) per
    scale and source, or under v1_multiscale K3 for each warped and each
    identity plane (and K4 for each warped one); K3 for each source's
    identity loss with automasking."""
    scales, sources = len(cfg.scales), len(cfg.frame_ids) - 1 + cfg.use_stereo
    out = {name: 0 for name in KERNELS}
    if cfg.v1_multiscale:
        out["reproj_loss"] = 2 * scales * sources
        out["reproj_loss_bwd"] = scales * sources if train else 0
    else:
        out["warp_reproj_loss"] = scales * sources
        out["warp_reproj_loss_bwd"] = scales * sources if train else 0
        out["reproj_loss"] = 0 if cfg.disable_automasking else sources
    return out


def check_float_warp_k6(device):
    """K6 on float frames at version 8, as v1_multiscale's scale-0 warps
    reach it: the float32 frame through grid_sample_fast on a small-motion
    grid (the v4 rung's gate holds) on the card against the same call on
    the CPU (the plain twins), values at TOL and the one K6 launch
    counted."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K

    gen = torch.Generator().manual_seed(21)
    src, _, small, _ = make_inputs(gen, "cpu")
    frame = src.float() / 255.0
    want = K.grid_sample_fast(frame, small, planar_out=True, version=8,
                              planar_grid=True)
    K.reset_counts()
    got = K.grid_sample_fast(frame.to(device), small.to(device),
                             planar_out=True, version=8, planar_grid=True)
    launches, rungs = K.counts(), K.rung_counts()
    err = float((got.cpu() - want).abs().max())
    print(f"  K6 on a float32 frame at version 8, {W}x{H}, small motion: "
          f"max_abs_err {err:.3e} against the CPU (tol {TOL:g}); rungs "
          f"{ {k: v for k, v in rungs.items() if v} }, fetch_corners "
          f"launches {launches['fetch_corners']}", flush=True)
    if not (err <= TOL and rungs["v4"] == 1 and (
            device != "cuda" or launches["fetch_corners"] == 1)):
        raise AssertionError("K6 on a float frame disagrees or did not "
                             "launch")


def run_option_group(name, device, dtype="bfloat16"):
    """Three training steps and one validation step of group ``name`` at
    B, H x W, the networks at ``dtype``; asserts finite losses and each
    step's launches, then the step repeated bit for bit; -> launches of
    the steps."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle
    from unsupervised_pose_estimation_tpu_torch.train.state import \
        create_train_state
    from unsupervised_pose_estimation_tpu_torch.train.step import (
        build_eval_step, build_train_step)

    opts = OPTION_GROUPS[name]
    bundle = ModelBundle.create(smoke_options(dtype=dtype, **opts),
                                seed=0, device=device)
    cfg = bundle.cfg
    state = create_train_state(bundle)
    step = build_train_step(bundle)
    gen = torch.Generator().manual_seed(22)
    batch = train_batch(gen, device, stereo=cfg.use_stereo)
    total = {k: 0 for k in KERNELS}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for k in range(4):
        train = k < 3
        K.reset_counts()
        start = time.perf_counter()
        if train:
            values = step(state, batch)
        else:
            values = build_eval_step(bundle)(
                batch, generator=torch.Generator(device).manual_seed(23))[0]
        if device == "cuda":
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - start)
        launches, rungs = K.counts(), K.rung_counts()
        values = {n: float(v) for n, v in values.items()}
        bad = [n for n, v in values.items() if not math.isfinite(v)]
        want = option_launches(cfg, train)
        k6 = sum(rungs[r] for r in K6_RUNGS)
        want["fetch_corners"] = k6
        scale0 = len(cfg.frame_ids) - 1 + cfg.use_stereo
        ladder_ok = (sum(rungs.values()) == scale0 if cfg.v1_multiscale
                     else not any(rungs.values()))
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device == "cuda" else float("nan"))
        print(f"  group {name} {dtype} {'train' if train else 'validation'} "
              f"step: "
              f"{ms:.1f} wall ms, peak {peak:.3f} GiB, loss "
              f"{values['loss']:.6f}, launches "
              f"{ {n: v for n, v in launches.items() if v} }, rungs "
              f"{ {r: v for r, v in rungs.items() if v} }", flush=True)
        if bad or (device == "cuda" and launches != want) or not ladder_ok:
            raise AssertionError(f"group {name}: non-finite {bad}, launches "
                                 f"{launches} (expected {want}), rungs "
                                 f"{rungs}")
        for n in total:
            total[n] += launches[n]
    check_step_repeats(bundle, batch)
    return total


def write_upstream_folder(folder):
    """A .pth folder of reference layout written from the port's own
    modules: ``encoder.pth`` and an upstream ``depth.pth`` (seed 4);
    -> the bundle that wrote it (on the CPU, bfloat16)."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle

    os.makedirs(folder)
    bundle = ModelBundle.create(smoke_options(
        dtype="bfloat16", depth_decoder_variant="upstream"), seed=4,
        device="cpu")
    torch.save({**bundle.encoder.state_dict(), "height": H, "width": W,
                "use_stereo": False}, os.path.join(folder, "encoder.pth"))
    torch.save(bundle.depth.state_dict(), os.path.join(folder, "depth.pth"))
    return bundle


def check_option_entry_points(root, device):
    """cli.train with OPTION_TRAIN_ARGS for 3 steps at B, H x W, a
    checkpoint at step 2 and a Trainer resumed from it whose step 3 and
    final state are bit-equal; then cli.evaluate_depth and an
    InferenceEngine on a .pth folder holding an upstream decoder, with the
    options at the default (fork) variant: both must build the detected
    upstream decoder. -> kernel launches of the training runs."""
    import io

    import torch

    from unsupervised_pose_estimation_tpu_torch.cli import evaluate_depth
    from unsupervised_pose_estimation_tpu_torch.cli.train import main as train
    from unsupervised_pose_estimation_tpu_torch.config import parse_options
    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.serve import InferenceEngine
    from unsupervised_pose_estimation_tpu_torch.train import loop
    from unsupervised_pose_estimation_tpu_torch.train.step import \
        build_infer_step

    args = TRAIN_ARGS + OPTION_TRAIN_ARGS + [
        "--batch_size", str(B), "--height", str(H), "--width", str(W),
        "--dataset", "synthetic_parallax", "--steps_per_epoch", "3",
        "--ckpt_frequency", "2"]
    straight, resumed = [], []
    K.reset_counts()
    undo = recording_steps(loop, straight)
    try:
        first = train(args + ["--log_dir", os.path.join(root, "a")],
                      device=device)
    finally:
        undo()
    ckpt = os.path.join(root, "a", "mdp", "models", "checkpoints")
    resume_from = os.path.join(root, "resume_from")
    os.makedirs(resume_from)
    shutil.copy(os.path.join(ckpt, "2.pt"), resume_from)
    undo = recording_steps(loop, resumed)
    try:
        second = loop.Trainer(parse_options(args + [
            "--log_dir", os.path.join(root, "b"),
            "--load_weights_folder", resume_from]), device=device)
        second.train()
    finally:
        undo()
    launches = K.counts()
    if [s for s, *_ in straight] != [0, 1, 2] or \
            [s for s, *_ in resumed] != [2]:
        raise AssertionError("the option runs took other steps")
    (_, batch_a, _, losses_a), (_, batch_b, _, losses_b) = (straight[2],
                                                            resumed[0])
    same = (all(torch.equal(batch_a[k], batch_b[k]) for k in batch_a)
            and all(torch.equal(losses_a[k], losses_b[k]) for k in losses_a))
    sa, sb = first.bundle.state_dict(), second.bundle.state_dict()
    same_state = all(torch.equal(sa[k], sb[k]) for k in sa)
    print(f"  cli.train {' '.join(OPTION_TRAIN_ARGS)} at batch {B}, {W}x{H}:"
          f" 3 steps, resumed step 3 bit-equal (batch, losses) {same}, "
          f"final parameters and statistics bit-equal {same_state}; "
          f"decoder {first.bundle.depth.variant}; launches "
          f"{ {n: v for n, v in launches.items() if v} }", flush=True)
    if not (same and same_state and first.bundle.depth.variant == "upstream"
            and (device != "cuda" or launches["reproj_loss_bwd"] > 0)):
        raise AssertionError("the options' resumed run is not bit-equal")

    folder = os.path.join(root, "pth")
    source = write_upstream_folder(folder)
    split_dir = write_split(root, H, W, B)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        row = evaluate_depth.main(
            ["--load_weights_folder", folder, "--height", str(H),
             "--width", str(W), "--batch_size", str(B), "--dataset",
             "synthetic_parallax", "--split_dir", split_dir, "--eval_split",
             "smoke", "--eval_mono"], device=device)
    print(out.getvalue().strip(), flush=True)
    engine = InferenceEngine(parse_options(
        ["--load_weights_folder", folder, "--height", str(H), "--width",
         str(W)]), max_batch=4, device=device)
    images = torch.rand((4, H, W, 3), generator=torch.Generator()
                        .manual_seed(24))
    got = engine.predict(images.numpy())
    want = build_infer_step(source.to(device))(images.to(device))[0][..., 0]
    err = float((torch.from_numpy(got) - want.cpu()).abs().max())
    print(f"  .pth folder with an upstream decoder, options at the fork "
          f"variant: cli.evaluate_depth abs_rel {row['abs_rel']:.4f}; "
          f"InferenceEngine decoder {engine.bundle.depth.variant}, "
          f"disparities against the writing bundle's max abs error "
          f"{err:.3e} (tol {TOL:g})", flush=True)
    if "detected as 'upstream'" not in out.getvalue() or \
            engine.bundle.depth.variant != "upstream" or err > TOL or \
            not all(math.isfinite(v) for v in row.values()):
        raise AssertionError("the upstream .pth folder was not evaluated "
                             "and served as its detected variant")
    return launches


@phase("options")
def phase_options(device="cuda"):
    """The training options of OPTION_GROUPS: each group's two training
    steps on the card against the CPU at a small size, in float32 and in
    bfloat16; K6 on a float frame at version 8; each group's steps at B,
    H x W in bfloat16 and in float32 with its launches, rungs, wall ms and
    peak memory;
    the entry points with the options. -> launches of the phase's runs."""
    for name, opts in OPTION_GROUPS.items():
        check_train_against_cpu(device, networks=False, options=opts)
        check_bf16_train_against_cpu(device, options=opts)
    check_float_warp_k6(device)
    total = {k: 0 for k in KERNELS}
    for name in OPTION_GROUPS:
        for dtype in ("bfloat16", "float32"):
            for k, v in run_option_group(name, device, dtype).items():
                total[k] += v
    root = tempfile.mkdtemp(prefix="chip_smoke_options_")
    try:
        for k, v in check_option_entry_points(root, device).items():
            total[k] += v
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  options phase launches {total}; {card_line()}", flush=True)
    if not total["fetch_corners"]:
        print("  K6 did not launch on the v1_multiscale paths at full size "
              "with these random weights (no rung's gate held); it is held "
              "on a float frame at version 8 above", flush=True)
    return total


# The GAN phase: the frozen generator's prior and the discriminator's
# update on the default configuration.
GAN_OPTIONS = dict(pre_trained_generator=True, adversarial_prior=True)


def check_disc_step_repeats(bundle, batch):
    """The disc step's loss and gradient twice from the same weights and
    batch under the trainer's deterministic cuDNN (a zero-rate SGD in
    place of its Adam, so that both start from the same discriminator):
    the real samples, the loss and every gradient must be the same
    bits."""
    import types

    import torch

    from unsupervised_pose_estimation_tpu_torch.train.loop import \
        deterministic_cudnn
    from unsupervised_pose_estimation_tpu_torch.train.step import (
        build_disc_step, gan_prior)

    disc = bundle.discriminator
    state = types.SimpleNamespace(
        disc_optimizer=torch.optim.SGD(disc.parameters(), lr=0.0))
    step = build_disc_step(bundle)
    runs = []
    with deterministic_cudnn():
        for _ in range(2):
            real = gan_prior(bundle, gan_inputs(batch)[0])
            loss = step(state, batch)["disc_loss"]
            runs.append((real, loss, {n: p.grad.clone()
                                      for n, p in disc.named_parameters()}))
    (r0, l0, g0), (r1, l1, g1) = runs
    differ = [n for n in g0 if not torch.equal(g0[n], g1[n])]
    same = torch.equal(r0, r1) and torch.equal(l0, l1) and not differ
    disc.zero_grad(set_to_none=True)
    print(f"  the disc step twice under deterministic cuDNN: real samples, "
          f"loss and {len(g0)} gradients bit-equal: {same}", flush=True)
    if not same:
        raise AssertionError(f"a repeated disc step differs {differ[:5]}")


def run_gan_steps(device, dtype):
    """Three training steps, each followed by a disc step, and one
    validation step of GAN_OPTIONS at B, H x W, the networks at ``dtype``:
    wall ms of each step and disc step (host clock, synchronised), peak
    memory, K1/K2/K3 launches asserted (8/8/2 a training step, 8/0/2 a
    validation step, none in a disc step), finite losses; then the step
    and the disc step repeated bit for bit; -> launches."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle
    from unsupervised_pose_estimation_tpu_torch.train.state import \
        create_train_state
    from unsupervised_pose_estimation_tpu_torch.train.step import (
        build_disc_step, build_eval_step, build_train_step)

    bundle = ModelBundle.create(smoke_options(dtype=dtype, **GAN_OPTIONS),
                                seed=0, device=device)
    cfg = bundle.cfg
    state = create_train_state(bundle)
    step, disc_step = build_train_step(bundle), build_disc_step(bundle)
    batch = train_batch(torch.Generator().manual_seed(25), device)
    total = {k: 0 for k in KERNELS}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def timed(fn, *args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        if device == "cuda":
            torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - start)

    for k in range(4):
        train = k < 3
        K.reset_counts()
        if train:
            values, ms = timed(step, state, batch)
        else:
            values, ms = timed(lambda: build_eval_step(bundle)(
                batch, generator=torch.Generator(device).manual_seed(26))[0])
        launches = K.counts()
        disc_ms = float("nan")
        if train:
            K.reset_counts()
            disc, disc_ms = timed(disc_step, state, batch)
            values.update(disc)
            if any(K.counts().values()):
                raise AssertionError(f"the disc step launched "
                                     f"{K.counts()}")
        values = {n: float(v) for n, v in values.items()}
        bad = [n for n, v in values.items() if not math.isfinite(v)]
        missing = [f"gan_loss/{s}" for s in cfg.scales
                   if f"gan_loss/{s}" not in values]
        want = option_launches(cfg, train)
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device == "cuda" else float("nan"))
        print(f"  GAN {dtype} {'train' if train else 'validation'} step: "
              f"{ms:.1f} wall ms"
              + (f", disc step {disc_ms:.1f} wall ms, disc_loss "
                 f"{values['disc_loss']:.6f}" if train else "")
              + f", peak {peak:.3f} GiB, loss {values['loss']:.6f}, "
              f"gan_loss/0 {values['gan_loss/0']:.6f}, launches "
              f"{ {n: v for n, v in launches.items() if v} }", flush=True)
        if bad or missing or (device == "cuda" and launches != want):
            raise AssertionError(f"GAN step: non-finite {bad}, missing "
                                 f"{missing}, launches {launches} "
                                 f"(expected {want})")
        for n in total:
            total[n] += launches[n]
    check_step_repeats(bundle, batch)
    check_disc_step_repeats(bundle, batch)
    return total


def check_gan_entry_points(root, device):
    """cli.train with the prior at its defaults (bfloat16) at B, H x W for
    3 steps, the generator read from a reference-layout .pth that this
    writes from seeded weights, a checkpoint at step 2, and a Trainer
    resumed from it whose step 3 (batch, losses) and final state
    (parameters, statistics, both Adams' moments, the discriminator's
    included) are bit-equal; then cli.evaluate_depth on the run's
    checkpoint with the run's options and no generator file. -> kernel
    launches of the training runs."""
    import io

    import torch

    from unsupervised_pose_estimation_tpu_torch.cli import evaluate_depth
    from unsupervised_pose_estimation_tpu_torch.cli.train import main as train
    from unsupervised_pose_estimation_tpu_torch.config import parse_options
    from unsupervised_pose_estimation_tpu_torch.models import \
        GeneratorResNet
    from unsupervised_pose_estimation_tpu_torch.models.layers import \
        init_weights
    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.train import loop

    generator = GeneratorResNet(1, 9)
    init_weights(generator, torch.Generator().manual_seed(27))
    path = os.path.join(root, "G_AB.pth")
    torch.save(generator.state_dict(), path)
    gan_args = ["--pre_trained_generator", "--adversarial_prior"]
    args = TRAIN_ARGS + gan_args + [
        "--generator_weights", path, "--batch_size", str(B), "--height",
        str(H), "--width", str(W), "--dataset", "synthetic_parallax",
        "--steps_per_epoch", "3", "--ckpt_frequency", "2"]
    straight, resumed = [], []
    K.reset_counts()
    undo = recording_steps(loop, straight)
    try:
        first = train(args + ["--log_dir", os.path.join(root, "a")],
                      device=device)
    finally:
        undo()
    ckpt = os.path.join(root, "a", "mdp", "models", "checkpoints")
    resume_from = os.path.join(root, "resume_from")
    os.makedirs(resume_from)
    shutil.copy(os.path.join(ckpt, "2.pt"), resume_from)
    undo = recording_steps(loop, resumed)
    try:
        second = loop.Trainer(parse_options(args + [
            "--log_dir", os.path.join(root, "b"),
            "--load_weights_folder", resume_from]), device=device)
        second.train()
    finally:
        undo()
    launches = K.counts()
    if [s for s, *_ in straight] != [0, 1, 2] or \
            [s for s, *_ in resumed] != [2]:
        raise AssertionError("the GAN runs took other steps")
    (_, batch_a, _, losses_a), (_, batch_b, _, losses_b) = (straight[2],
                                                            resumed[0])
    same = (all(torch.equal(batch_a[k], batch_b[k]) for k in batch_a)
            and all(torch.equal(losses_a[k], losses_b[k]) for k in losses_a))
    sa, sb = first.bundle.state_dict(), second.bundle.state_dict()
    same_state = all(torch.equal(sa[k], sb[k]) for k in sa)
    for name in ("optimizer", "disc_optimizer"):
        oa = getattr(first.state, name).state_dict()["state"]
        ob = getattr(second.state, name).state_dict()["state"]
        same_state = same_state and oa.keys() == ob.keys() and all(
            torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])
    loaded = all(torch.equal(sa[f"generator.{k}"], v.to(device))
                 for k, v in generator.state_dict().items())
    print(f"  cli.train {' '.join(gan_args)} --generator_weights <.pth> at "
          f"batch {B}, {W}x{H}: 3 steps, resumed step 3 bit-equal (batch, "
          f"losses) {same}, final parameters, statistics and both Adams' "
          f"moments bit-equal {same_state}, generator as written "
          f"{loaded}; launches "
          f"{ {n: v for n, v in launches.items() if v} }", flush=True)
    if not (same and same_state and loaded
            and (device != "cuda" or launches["warp_reproj_loss_bwd"]
                 == 8 * 4)):
        raise AssertionError("the GAN run's resume is not bit-equal")

    split_dir = write_split(root, H, W, B)
    out = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        row = evaluate_depth.main(
            ["--load_weights_folder", ckpt, "--height", str(H), "--width",
             str(W), "--batch_size", str(B), "--dataset",
             "synthetic_parallax", "--split_dir", split_dir, "--eval_split",
             "smoke", "--eval_mono"] + gan_args, device=device)
    ms = 1e3 * (time.perf_counter() - start)
    print(f"  cli.evaluate_depth on the GAN run's checkpoint with its "
          f"options: abs_rel {row['abs_rel']:.4f}, a1 {row['a1']:.4f} "
          f"({B} items, {ms:.1f} wall ms)", flush=True)
    if not all(math.isfinite(v) for v in row.values()):
        raise AssertionError(f"non-finite metrics {row}")
    return launches


@phase("gan")
def phase_gan(device="cuda"):
    """The GAN prior (GAN_OPTIONS): two training and disc steps on the card
    against the CPU at a small size, in float32 and in bfloat16; three
    training and disc steps and one validation step at B, H x W in
    bfloat16 and in float32; the entry points with the prior. -> launches
    of the phase's runs."""
    check_train_against_cpu(device, networks=False, options=GAN_OPTIONS)
    check_bf16_train_against_cpu(device, options=GAN_OPTIONS)
    total = {k: 0 for k in KERNELS}
    for dtype in ("bfloat16", "float32"):
        for k, v in run_gan_steps(device, dtype).items():
            total[k] += v
    root = tempfile.mkdtemp(prefix="chip_smoke_gan_")
    try:
        for k, v in check_gan_entry_points(root, device).items():
            total[k] += v
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  GAN phase launches {total}; {card_line()}", flush=True)
    return total


# Phase 11, the mesh (parallel.mesh) at the flagship feed: B rows over two
# ranks of B / 2, MESH_STEPS steps, a checkpoint after step MESH_CKPT_AT
# and a resume from it. Two ranks on one card are a check of values, not a
# speed: their times are no measure of scaling.
MESH_STEPS, MESH_CKPT_AT = 3, 2
MESH_ARGS = ["--dataset", "synthetic_parallax", "--weights_init", "scratch",
             "--num_epochs", "1", "--steps_per_epoch", str(MESH_STEPS),
             "--log_frequency", str(MESH_STEPS), "--ckpt_frequency", "0",
             "--num_workers", "8"]


def check_one_nccl_rank(root, device):
    """(a) cli.train at its defaults for MESH_STEPS steps, first without a
    process group, then under torchrun's environment for one process
    (WORLD_SIZE=1), which starts an NCCL group: the trainer's gradient and
    loss all-reduces then run through NCCL; a group of one adds nothing,
    so every step's losses and the final parameters and statistics must be
    bit-equal. -> launches of both runs."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.cli.train import main as train
    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.parallel import mesh as M
    from unsupervised_pose_estimation_tpu_torch.parallel.dryrun import \
        free_port
    from unsupervised_pose_estimation_tpu_torch.train import loop

    args = MESH_ARGS + ["--batch_size", str(B), "--height", str(H),
                        "--width", str(W)]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    total = {k: 0 for k in KERNELS}
    runs = {}
    for name, extra in (("no group", {}), ("NCCL WORLD_SIZE=1", env)):
        seen = []
        undo = recording_steps(loop, seen)
        os.environ.update(extra)
        K.reset_counts()
        collectives = sum(M.COUNTS.values())
        try:
            trainer = train(args + ["--log_dir", os.path.join(
                root, name.replace(" ", "_"))], device=device)
        finally:
            undo()
            for key in extra:
                os.environ.pop(key)
        for k, v in K.counts().items():
            total[k] += v
        entries = [t for _, _, t, _ in seen]
        runs[name] = dict(
            losses=[losses for *_, losses in seen],
            state={k: v.detach().cpu() for k, v in
                   trainer.bundle.state_dict().items()},
            ms=[round(1e3 * (b - a), 1) for a, b in zip(entries,
                                                         entries[1:])],
            group=trainer.mesh.group is not None,
            collectives=sum(M.COUNTS.values()) - collectives)
    plain, nccl = runs["no group"], runs["NCCL WORLD_SIZE=1"]
    if plain["group"] or not nccl["group"] or not nccl["collectives"]:
        raise AssertionError("the NCCL run did not train over its group")
    unequal = [f"step {k} {name}" for k, (a, b) in enumerate(
        zip(plain["losses"], nccl["losses"])) for name in a
        if not torch.equal(a[name], b[name])]
    unequal += [key for key, v in plain["state"].items()
                if not torch.equal(v, nccl["state"][key])]
    print(f"  (a) cli.train, {MESH_STEPS} steps at batch {B}, {H}x{W}, "
          f"bf16: wall ms between step starts without a group "
          f"{plain['ms']}, with an NCCL group of one {nccl['ms']} "
          f"({nccl['collectives']} collectives); losses and final "
          f"parameters and statistics bit-equal: {not unequal}", flush=True)
    if unequal:
        raise AssertionError(f"the NCCL run differs: {unequal[:5]}")
    return total


def bf16_mesh_failures(res):
    """The phase-5 bfloat16 bounds on a bfloat16 case of the dry run, per
    step against the one-process step from the same state: each loss
    within BF16_LOSS times the largest bf16-float32 gap of the one-process
    losses plus 1e-4 of its value; the share of parameters whose update
    took the other sign within BF16_MEAN times that share between the
    one-process bf16 and float32 updates; the statistics within BF16_MAX
    times their gap. -> (failures, the worst shares of each bound)."""
    failed, worst = [], [0.0, 0.0, 0.0]
    for k, st in enumerate(res["steps"]):
        cmp, got = st["compare"], st["losses"]
        ref, f32 = cmp["ref_losses"], cmp["f32_losses"]
        keys = [n for n in ref if n != "grad_norm"]
        gap = max(abs(ref[n] - f32[n]) for n in keys)
        shares = (max(abs(got[n] - ref[n]) / (BF16_LOSS * gap + 1e-4
                                                * abs(ref[n])) for n in keys),
                  cmp["flipped"] / (BF16_MEAN * cmp["flipped_gap"]),
                  cmp["stats_max"] / (BF16_MAX * cmp["stats_gap"]))
        worst = [max(a, b) for a, b in zip(worst, shares)]
        if not max(shares) <= 1.0:
            failed.append(f"step {k}: shares of the bf16 bounds {shares}")
    return failed, worst


def check_two_ranks(root, device="cuda"):
    """(b) Two ranks on the one card, two processes through gloo
    (``parallel.dryrun``; NCCL refuses two ranks on one device):
    ``mesh_data=2``, then ``mesh_data=1 mesh_fsdp=2``, in float32 (TF32
    off), and ``mesh_data=2`` in bfloat16, MESH_STEPS steps each on global
    batches of B ``synthetic_parallax`` items, every step held to the
    one-process step from the same state (float32: ``dryrun.check``'s
    bounds; bfloat16: ``bf16_mesh_failures``), the ranks bit-identical
    after every step, a checkpoint after step MESH_CKPT_AT written once,
    and the run resumed from it bit-equal. fsdp runs the arithmetic of
    ``mesh_data=2`` (the same all-reduced gradient; Adam is elementwise),
    so its steps must also repeat that case's bit for bit. -> the ranks'
    launches."""
    import torch

    from unsupervised_pose_estimation_tpu_torch.config import Options
    from unsupervised_pose_estimation_tpu_torch.parallel import dryrun

    start = time.perf_counter()
    # the global batches, rendered once here for both ranks
    batches = os.path.join(root, "batches.pt")
    torch.save({"batches": dryrun.make_batches(
        Options(height=H, width=W, batch_size=B), MESH_STEPS, "cpu"),
        "noise": [None] * MESH_STEPS}, batches)
    cases = [{"name": f"{mesh}_{dtype}", "steps": MESH_STEPS,
              "compare": MESH_STEPS, "ckpt_at": MESH_CKPT_AT,
              "batch": batches,
              "options": dict(height=H, width=W, batch_size=B,
                              learning_rate=LR, compute_dtype=dtype,
                              **layout)}
             for mesh, dtype, layout in (
                 ("data", "float32", dict(mesh_data=2)),
                 ("fsdp", "float32", dict(mesh_data=1, mesh_fsdp=2)),
                 ("data", "bfloat16", dict(mesh_data=2)))]
    results = dryrun.launch(cases, 2, "cuda:0" if device == "cuda" else
                            device, os.path.join(root, "ranks"),
                            timeout=300, threads=4)
    print(f"  (b) two ranks through gloo on one card: {len(cases)} cases "
          f"in {time.perf_counter() - start:.1f} s (the batches' rendering "
          f"and the processes' start included)", flush=True)
    total = {k: 0 for k in KERNELS}
    failed = []
    for case in cases:
        name = case["name"]
        ranks = [r[name] for r in results]
        head = ranks[0]
        fails = dryrun.check(results, name)
        if name.startswith("fsdp"):
            twin = results[0][name.replace("fsdp", "data")]["steps"]
            if [(st["digest"], st["losses"]) for st in head["steps"]] != [
                    (st["digest"], st["losses"]) for st in twin]:
                fails.append("its steps differ from mesh_data=2's")
        if head["bf16"]:
            more, worst = bf16_mesh_failures(head)
            fails += more
            detail = (f"bf16 bounds' worst shares: losses {worst[0]:.3f}, "
                      f"update signs {worst[1]:.3f}, statistics "
                      f"{worst[2]:.3f}")
        else:
            cmp = [st["compare"] for st in head["steps"]]
            rel = max(abs(st["losses"][n] - c["ref_losses"][n])
                      / abs(c["ref_losses"][n])
                      for st, c in zip(head["steps"], cmp)
                      for n in c["ref_losses"] if n != "grad_norm")
            detail = (f"losses' worst relative error {rel:.3e} (tol "
                      f"{dryrun.LOSS_RTOL}), parameters "
                      f"{max(c['param_max'] for c in cmp) / LR:.3f} lr "
                      f"apart (tol {dryrun.PARAM_LR} lr + "
                      f"{dryrun.PARAM_ATOL}), at most "
                      f"{max(c['param_beyond_0.1lr'] for c in cmp):.3%} of "
                      f"them more than 0.1 lr apart (tol "
                      f"{dryrun.BEYOND_SHARE:.0%}), statistics "
                      f"{max(c['stats_max'] for c in cmp):.3e} (tol "
                      f"{dryrun.STATS_ATOL})")
        for res in ranks:
            for k, v in res["launches"].items():
                total[k] += v
        per_step = {k: v // MESH_STEPS for k, v in
                    head["launches"].items() if v}
        held = [[r["bytes"][k] for k in ("parameters", "exp_avg",
                                          "exp_avg_sq")] for r in ranks]
        by_part = {k: round(v, 1) for k, v in head["seconds_by_part"].items()}
        print(f"  {name} ({head['seconds']:.1f} s on rank 0: {by_part}): ms "
              f"per step by rank "
              f"{[[round(st['ms'], 1) for st in r['steps']] for r in ranks]};"
              f" {head['steps'][-1]['collectives']} collectives a step; "
              f"launches per rank and step {per_step}; peak GiB by rank "
              f"{[round((r['peak_bytes'] or 0) / 2**30, 3) for r in ranks]}; "
              f"bytes held by rank (parameters, exp_avg, exp_avg_sq of "
              f"{head['bytes']['total']}) {held}; "
              f"{detail}; ranks bit-identical after every step and the "
              f"resume from step {MESH_CKPT_AT} bit-equal: "
              f"{not [f for f in fails if 'differ' in f or 'bit' in f]}",
              flush=True)
        if device == "cuda" and (per_step.get("warp_reproj_loss") != 8 or
                                 per_step.get("warp_reproj_loss_bwd") != 8):
            fails.append(f"launches {head['launches']}")
        failed += [f"{name}: {f}" for f in fails]
    if failed:
        raise AssertionError(f"the mesh disagrees: {failed}")
    return total


def phase_mesh(device="cuda"):
    """Phase 11 (the mesh): (a) ``check_one_nccl_rank``, (b)
    ``check_two_ranks``. -> the launches of both."""
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        total = check_one_nccl_rank(root, device)
        for k, v in check_two_ranks(root, device).items():
            total[k] += v
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  mesh phase launches {total}; {card_line()}", flush=True)
    return total


# Phase 12: files and serving without PIL. Host routines of the image
# codec (csrc/image_host.cpp), held to their numpy versions bit for bit.
HOST_ROUTINES = {
    "png_unfilter": dict(
        replaces="PIL's PNG decoder (PngImagePlugin), its unfilter"),
    "resample_horizontal_u8": dict(
        replaces="PIL's Image.resize LANCZOS (Resample.c), horizontal pass"),
    "resample_vertical_u8": dict(
        replaces="PIL's Image.resize LANCZOS (Resample.c), vertical pass"),
}
HOST_SOURCE = "unsupervised_pose_estimation_tpu_torch/csrc/image_host.cpp"
FRAME_H, FRAME_W = 1024, 1280   # the lung frames' size
FILE_FRAMES = 44                # one sequence: 28 train and 14 val lines
FILE_PICTURES = 8               # distinct pictures among the frames
# (h, w) -> (out_h, out_w): SCARED after its crop, KITTI, 480x640, and
# upscaling, odd, tiny and unchanged sizes
LANCZOS_SHAPES = [((960, 1280), (192, 640)), ((375, 1242), (192, 640)),
                  ((480, 640), (192, 640)), ((32, 32), (64, 48)),
                  ((7, 13), (5, 29)), ((1, 5), (3, 2)), ((20, 30), (20, 30))]
HTTP_REQUESTS = 16


def lung_picture(k, h=FRAME_H, w=FRAME_W):
    """A smooth RGB texture sliding 2 px a frame, with noise."""
    import numpy as np

    rng = np.random.default_rng(100 + k)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    pix = np.empty((h, w, 3), np.float32)
    for c in range(3):
        pix[..., c] = 127.5 + 100 * np.sin(0.02 * (xs + 2 * k)
                                           + 0.015 * ys * (c + 1))
    pix += rng.normal(0, 6, (h, w, 3))
    return np.clip(pix, 0, 255).astype(np.uint8)


def as_palette(data):
    """An 8-bit grey PNG as a palette PNG of the same indices (colour type
    3 with a 256-entry PLTE): the same unfilter at one byte a pixel."""
    import struct
    import zlib

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = bytearray(data[16:29])
    ihdr[9] = 3
    plte = bytes((i * 7 + c * 85) % 256 for i in range(256)
                 for c in range(3))
    return data[:8] + chunk(b"IHDR", bytes(ihdr)) + chunk(b"PLTE", plte) + \
        data[33:]


def host_ms(fn, repeat):
    start = time.perf_counter()
    for _ in range(repeat):
        out = fn()
    return 1e3 * (time.perf_counter() - start) / repeat, out


def check_host_routines():
    """The native unfilter against numpy on encode_png files of every
    colour type read, with each forced filter type, mixed per-row types and
    the adaptive choice, at 1280x1024 (RGB every type; the others mixed)
    and at ragged sizes; the native LANCZOS passes against numpy on
    LANCZOS_SHAPES; host ms per frame of each route. -> host records."""
    import numpy as np

    from unsupervised_pose_estimation_tpu_torch.data import png, resample
    from unsupervised_pose_estimation_tpu_torch.ops.kernels import _lib

    _lib.reset_counts()
    rng = np.random.default_rng(12)
    rgb = lung_picture(0)

    def layouts(pix):
        grey = pix[..., 1]
        return {"grey": grey, "grey_alpha": pix[..., :2], "rgb": pix,
                "rgba": np.concatenate([pix, pix[..., :1]], -1),
                "palette": grey,
                "grey16": grey.astype(np.uint16) * 257 + pix[..., 0]}

    files = []
    for size in ((FRAME_H, FRAME_W), (37, 53), (1, 1), (5, 3)):
        pix = rgb[:size[0], :size[1]]
        for name, arr in layouts(pix).items():
            big = size == (FRAME_H, FRAME_W)
            kinds = ([0, 1, 2, 3, 4, None] if not big or name == "rgb"
                     else []) + [rng.integers(0, 5, size[0])]
            for kind in kinds:
                data = png.encode_png(arr, filter=kind, level=1)
                if name == "palette":
                    data = as_palette(data)
                files.append((name, size, data))
    worst = 0
    for name, size, data in files:
        got = png.decode_png(data, native=True)
        want = png.decode_png(data)
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"native unfilter differs: {name} {size}")
    frame = png.encode_png(rgb)  # the adaptive filters, zlib level 6
    native_ms, _ = host_ms(lambda: png.decode_png(frame, native=True), 5)
    numpy_ms, _ = host_ms(lambda: png.decode_png(frame), 1)
    print(f"  unfilter: {len(files)} files bit-equal (6 colour types x "
          f"forced, mixed and adaptive filters; 1280x1024 and ragged); "
          f"decode of a 1280x1024 RGB frame {native_ms:.2f} ms native, "
          f"{numpy_ms:.2f} ms numpy (host)", flush=True)
    records = {"png_unfilter": dict(ms=native_ms, numpy_ms=numpy_ms)}
    resize = {}
    for (h, w), (oh, ow) in LANCZOS_SHAPES:
        img = rgb[:h, :w] if h <= FRAME_H and w <= FRAME_W else \
            lung_picture(1, h, w)
        n_ms, got = host_ms(
            lambda: resample.resize_lanczos(img, oh, ow, native=True), 5)
        p_ms, want = host_ms(lambda: resample.resize_lanczos(img, oh, ow), 1)
        if not np.array_equal(got, want):
            raise AssertionError(f"native LANCZOS differs at {(h, w)} -> "
                                 f"{(oh, ow)}")
        resize[f"{h}x{w}->{oh}x{ow}"] = (round(n_ms, 3), round(p_ms, 3))
    print(f"  LANCZOS native vs numpy bit-equal; host ms per frame (native, "
          f"numpy): {resize}", flush=True)
    n_ms, p_ms = resize["960x1280->192x640"]
    for name in ("resample_horizontal_u8", "resample_vertical_u8"):
        records[name] = dict(ms=n_ms, numpy_ms=p_ms,
                             shape="960x1280->192x640 (both passes)")
    return records, _lib.host_counts()


def check_file_training(root, device):
    """A lung tree of FILE_FRAMES 1280x1024 PNGs (encode_png), its split
    files (data.make_splits), cli.build_frame_cache, then cli.train for two
    steps from the files (with --log_images) and two from the cache: the
    batches bit-equal; -> the log directory of the first run."""
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from unsupervised_pose_estimation_tpu_torch.cli import build_frame_cache
    from unsupervised_pose_estimation_tpu_torch.cli.train import main as train
    from unsupervised_pose_estimation_tpu_torch.data.make_splits import \
        write_split
    from unsupervised_pose_estimation_tpu_torch.data.png import encode_png
    from unsupervised_pose_estimation_tpu_torch.train import loop

    lung = os.path.join(root, "lung")
    os.makedirs(os.path.join(lung, "seq1"))
    start = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        pictures = list(pool.map(lambda k: encode_png(lung_picture(k)),
                                 range(FILE_PICTURES)))
    for i in range(FILE_FRAMES):
        with open(os.path.join(lung, "seq1", f"{i:010d}.png"), "wb") as f:
            f.write(pictures[i % FILE_PICTURES])
    split_dir = os.path.join(root, "splits")
    write_split(lung, os.path.join(split_dir, "lung_files"),
                val_fraction=1 / 3, suffix="")
    print(f"  lung tree: {FILE_FRAMES} PNGs of {FRAME_W}x{FRAME_H} "
          f"({sum(map(len, pictures)) / FILE_PICTURES / 2**20:.2f} MiB "
          f"each) in {time.perf_counter() - start:.2f} s", flush=True)
    args = TRAIN_ARGS + ["--batch_size", str(B), "--height", str(H),
                         "--width", str(W), "--dataset", "endovis",
                         "--split", "lung_files", "--split_dir", split_dir,
                         "--data_path", lung, "--steps_per_epoch", "2"]
    cache = os.path.join(root, "cache")
    start = time.perf_counter()
    stats = build_frame_cache.main(args + ["--frame_cache", cache],
                                   device=device)
    seconds = time.perf_counter() - start
    rows = stats["train"]["rows"] + stats["val"]["rows"]
    print(f"  cli.build_frame_cache: {rows} frames in {seconds:.2f} s "
          f"({rows / seconds:.1f} frames/s decoded and resized, "
          f"{FRAME_W}x{FRAME_H} -> {W}x{H})", flush=True)
    runs = {}
    for tag, extra in (("files", ["--log_images"]),
                       ("cache", ["--frame_cache", cache])):
        seen = []
        undo = recording_steps(loop, seen)
        try:
            trainer = train(args + extra + ["--log_dir",
                                             os.path.join(root, tag)],
                            device=device)
        finally:
            undo()
        if len(seen) != 2:
            raise AssertionError(f"{tag}: {len(seen)} steps")
        check_batches_against_host(seen, trainer.train_loader)
        loader = trainer.train_loader
        gap = seen[1][2] - seen[0][2]
        wait = 1e3 * loader.wait_seconds / loader.batches
        # the input pipeline alone: one more epoch of batches to the card
        start = time.perf_counter()
        batches = loader.epoch(1)
        try:
            n = sum(1 for _ in batches)
        finally:
            batches.close()
        rate = n * B / (time.perf_counter() - start)
        print(f"  cli.train from the {tag}: 2 steps, {B / gap:.1f} frames/s "
              f"between the step starts (step 0 with the first validation), "
              f"loader wait {wait:.1f} ms a batch, loss "
              f"{float(seen[-1][3]['loss']):.6f}; the loader alone "
              f"{rate:.1f} frames/s over {n} batches", flush=True)
        runs[tag] = seen
    for (step, a, _, _), (_, b, _, _) in zip(runs["files"], runs["cache"]):
        for key in a:
            if not torch.equal(a[key], b[key]):
                raise AssertionError(f"step {step}: batch['{key}'] from the "
                                     f"files differs from the cache's")
    print("  batches from the files and from the cache bit-equal",
          flush=True)
    return lung, os.path.join(root, "files")


def check_logged_images(log_dir):
    """--log_images wrote 8-bit grey or RGB PNGs that decode_png reads
    (the disparities at each scale's size)."""
    import numpy as np

    from unsupervised_pose_estimation_tpu_torch.data.png import read_png

    step_dir = os.path.join(log_dir, "mdp", "images", "step_0")
    names = sorted(os.listdir(step_dir))
    shapes = set()
    for name in names:
        arr = read_png(os.path.join(step_dir, name), native=True)
        if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or \
                (arr.ndim == 3 and arr.shape[-1] != 3):
            raise AssertionError(f"{name}: {arr.shape} {arr.dtype}")
        shapes.add(arr.shape)
    if not names:
        raise AssertionError("--log_images wrote no PNG")
    print(f"  --log_images: {len(names)} PNGs read back, shapes "
          f"{sorted(shapes)}", flush=True)


def check_http(lung, device):
    """The HTTP front end with a bf16 engine and a float32 engine:
    HTTP_REQUESTS concurrent POSTs of 1280x1024 PNG frames; each answer
    equal to the engine's disparity of the decoded frame in the batch that
    served it (each engine call recorded) and the feed equal to the local
    decode; -> {dtype: (p50 ms, p99 ms)}."""
    import io
    import urllib.request

    import numpy as np

    from unsupervised_pose_estimation_tpu_torch.serve import (
        InferenceEngine, MicroBatcher, decode_request, make_http_server)

    names = sorted(os.listdir(os.path.join(lung, "seq1")))
    bodies = []
    for name in names[:HTTP_REQUESTS]:
        with open(os.path.join(lung, "seq1", name), "rb") as f:
            bodies.append(f.read())
    feeds = [decode_request(body, H, W, native=True)
             for body in bodies[:FILE_PICTURES]]
    latencies = {}
    for dtype in ("bfloat16", "float32"):
        engine = InferenceEngine(smoke_options(dtype=dtype), max_batch=8,
                                 device=device)
        served = []
        real = engine.predict

        def recording(images, real=real, served=served):
            out = real(images)
            served.extend(zip(images, out))
            return out

        engine.predict = recording
        batcher = MicroBatcher(engine, max_delay_ms=5.0)
        server = make_http_server(batcher)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}/predict"
        got, took, errors = {}, {}, []

        def client(i):
            req = urllib.request.Request(url, data=bodies[i], method="POST")
            start = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    got[i] = np.load(io.BytesIO(resp.read()))
            except Exception as err:  # reported below, fails the phase
                errors.append(repr(err))
            took[i] = 1e3 * (time.perf_counter() - start)

        try:
            client(0)  # the first call chooses cuDNN's algorithms
            served.clear()
            got.clear()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(HTTP_REQUESTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180)
        finally:
            server.shutdown()
            server.server_close()
            batcher.close()
            thread.join(timeout=30)
        if errors or len(got) != HTTP_REQUESTS:
            raise AssertionError(f"HTTP {dtype}: {errors or len(got)}")
        for i in range(HTTP_REQUESTS):
            feed = feeds[i % FILE_PICTURES]
            rows = [out for image, out in served
                    if np.array_equal(image, feed)]
            if not any(np.array_equal(got[i], out) for out in rows):
                raise AssertionError(f"HTTP {dtype}: answer {i} is not the "
                                     f"engine's disparity of its frame")
        ms = sorted(took[i] for i in range(HTTP_REQUESTS))
        latencies[dtype] = (statistics.median(ms),
                            ms[min(len(ms) - 1, int(0.99 * len(ms)))])
        print(f"  HTTP {dtype}: {HTTP_REQUESTS} concurrent POSTs of "
              f"{FRAME_W}x{FRAME_H} PNGs answered with the engine's "
              f"disparities ({engine.calls - 1} engine calls); latency p50 "
              f"{latencies[dtype][0]:.1f} ms, p99 {latencies[dtype][1]:.1f} "
              f"ms (decode, resize and the engine; {card_line()})",
              flush=True)
    return latencies


def check_artifacts(root, device):
    """export_artifact -> load_artifact against the engine: float32 within
    1e-6, bf16 within phase 4's bound (BF16_* of the engine's own
    bf16-float32 gap)."""
    import numpy as np
    import torch

    from unsupervised_pose_estimation_tpu_torch.serve import (
        InferenceEngine, export_artifact, load_artifact)

    x = np.random.default_rng(5).random((8, H, W, 3)).astype(np.float32)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        opt = smoke_options(dtype=dtype)
        engine = InferenceEngine(opt, max_batch=8, device=device)
        start = time.perf_counter()
        path = export_artifact(opt, os.path.join(root, f"{dtype}.pt2"),
                               max_batch=8, bundle=engine.bundle,
                               device=device)
        fn, meta = load_artifact(path, device=device)
        seconds = time.perf_counter() - start
        art = fn(torch.from_numpy(x).to(device)).cpu()
        outs[dtype] = (art, torch.from_numpy(engine.predict(x)))
        err = float((art - outs[dtype][1]).abs().max())
        print(f"  artifact {dtype}: exported and loaded in {seconds:.2f} s "
              f"({os.path.getsize(path) / 2**20:.1f} MiB), max |artifact - "
              f"engine| {err:.3e}, meta {meta}", flush=True)
        if dtype == "float32" and not err <= 1e-6:
            raise AssertionError("the float32 artifact differs from the "
                                 "engine")
    art, eng16 = (t.double() for t in outs["bfloat16"])
    gap = (eng16 - outs["float32"][1].double()).abs()
    err = (art - eng16).abs()
    ratios = (float(err.max() / gap.max()), float(err.mean() / gap.mean()))
    print(f"  bf16 artifact against the bf16 engine: max {ratios[0]:.2f}x "
          f"the engine's bf16-float32 gap (tol {BF16_MAX}), mean "
          f"{ratios[1]:.2f}x (tol {BF16_MEAN})", flush=True)
    if not (float(gap.max()) > 0 and ratios[0] <= BF16_MAX
            and ratios[1] <= BF16_MEAN):
        raise AssertionError("the bf16 artifact differs from the engine")


def check_file_tools(root, lung, ckpt, device):
    """cli.test_simple on phase 7's checkpoint over two lung frames;
    cli.export_gt_depth on an eigen_benchmark tree of 16-bit PNGs;
    --eval_split benchmark's PNGs read back with decode_png."""
    import numpy as np

    from unsupervised_pose_estimation_tpu_torch.cli import (evaluate_depth,
                                                            export_gt_depth,
                                                            test_simple)
    from unsupervised_pose_estimation_tpu_torch.data.png import (read_png,
                                                                 write_png)
    from unsupervised_pose_estimation_tpu_torch.eval.metrics import \
        resize_bilinear_np

    images = os.path.join(root, "images")
    os.makedirs(images)
    for i in range(2):
        shutil.copy(os.path.join(lung, "seq1", f"{i:010d}.png"),
                    os.path.join(images, f"f{i}.png"))
    start = time.perf_counter()
    test_simple.main(["--image_path", images, "--model_path", ckpt,
                      "--height", str(H), "--width", str(W),
                      "--pose_prediction"], device=device)
    seconds = time.perf_counter() - start
    for i in range(2):
        disp = np.load(os.path.join(images, f"f{i}_disp.npy"))
        with open(os.path.join(images, f"f{i}_disp.jpg"), "rb") as f:
            jpeg = f.read()
        if disp.shape != (1, 1, H, W) or not np.isfinite(disp).all() or \
                jpeg[:2] != b"\xff\xd8" or jpeg[-2:] != b"\xff\xd9":
            raise AssertionError(f"test_simple: {disp.shape}, jpeg "
                                 f"{jpeg[:2]!r}..{jpeg[-2:]!r}")
    transform = np.loadtxt(os.path.join(images, "transform.csv"),
                           delimiter=",")
    rot = transform[:3, :3]
    if transform.shape != (4, 4) or \
            not np.allclose(rot @ rot.T, np.eye(3), atol=1e-5):
        raise AssertionError(f"test_simple transform {transform}")
    print(f"  cli.test_simple on the trainer's checkpoint: 2 frames of "
          f"{FRAME_W}x{FRAME_H} in {seconds:.2f} s (the checkpoint's load "
          f"included); .npy, magma .jpg and the pose CSVs", flush=True)

    kitti = os.path.join(root, "kitti")
    folder = "2011_09_26/2011_09_26_drive_0002_sync"
    gt_dir = os.path.join(kitti, folder, "proj_depth", "groundtruth",
                          "image_02")
    os.makedirs(gt_dir)
    split_dir = os.path.join(root, "kitti_splits")
    os.makedirs(os.path.join(split_dir, "eigen_benchmark"))
    rng = np.random.default_rng(6)
    maps = []
    for i, (h, w) in enumerate([(375, 1242), (370, 1224), (376, 1241)]):
        depth = rng.integers(0, 20000, (h, w)).astype(np.uint16)
        depth[rng.random((h, w)) < 0.7] = 0
        write_png(os.path.join(gt_dir, f"{i:010d}.png"), depth)
        maps.append(depth.astype(np.float32) / 256.0)
    with open(os.path.join(split_dir, "eigen_benchmark", "test_files.txt"),
              "w") as f:
        f.write("".join(f"{folder} {i} l\n" for i in range(3)))
    path = export_gt_depth.main(["--data_path", kitti, "--split",
                                 "eigen_benchmark", "--split_dir",
                                 split_dir], device=device)
    got = np.load(path, allow_pickle=True)["data"]
    if len(got) != 3 or not all(np.array_equal(a, b)
                                for a, b in zip(got, maps)):
        raise AssertionError("export_gt_depth's npz differs from the maps")
    print("  cli.export_gt_depth: 3 annotated 16-bit PNGs -> gt_depths.npz "
          "equal to the maps / 256", flush=True)

    disps = rng.random((2, H, W)).astype(np.float32) * 0.3 + 0.01
    np.save(os.path.join(root, "disps.npy"), disps)
    bench = os.path.join(root, "bench")
    os.makedirs(bench)
    evaluate_depth.main(["--eval_split", "benchmark", "--eval_mono",
                         "--ext_disp_to_eval",
                         os.path.join(root, "disps.npy"),
                         "--load_weights_folder", bench], device=device)
    for i in range(2):
        want = (np.clip(5.4 / np.maximum(resize_bilinear_np(
            disps[i], 352, 1216), 1e-9), 0, 80) * 256).astype(np.uint16)
        got = read_png(os.path.join(bench, "benchmark_predictions",
                                    f"{i:010d}.png"), native=True)
        if not np.array_equal(got, want):
            raise AssertionError("benchmark PNG differs")
    print("  --eval_split benchmark: 2 16-bit PNGs read back equal",
          flush=True)


@phase("files and serving")
def phase_files(ckpt, device="cuda"):
    """Phase 12: ``check_host_routines``, ``check_file_training``,
    ``check_logged_images``, ``check_http``, ``check_artifacts``,
    ``check_file_tools``. -> (host records, host call counts, HTTP
    latencies, kernel launches of the phase)."""
    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.ops.kernels import _lib

    records, calls = check_host_routines()
    root = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        K.reset_counts()
        lung, log_dir = check_file_training(root, device)
        launches = K.counts()
        check_logged_images(log_dir)
        for name, n in _lib.host_counts().items():
            calls[name] += n
        latencies = check_http(lung, device)
        check_artifacts(root, device)
        check_file_tools(root, lung, ckpt, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  files phase launches {launches}; {card_line()}", flush=True)
    if device == "cuda" and (launches["warp_reproj_loss_bwd"] != 32):
        raise AssertionError(f"files phase launches {launches}")
    return records, calls, latencies, launches


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.ops.kernels import _lib

    print(card_line(), flush=True)
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

    launches = {name: 0 for name in KERNELS}

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    records = phase_kernels()
    for dtype in ("float32", "bfloat16"):
        add(phase(f"eval_step {dtype}")(phase_eval_step)(dtype=dtype))
    for dtype in ("float32", "bfloat16"):
        K.reset_counts()
        phase(f"serve {dtype}")(phase_serve)(dtype=dtype)
        add(K.counts())
    for dtype in ("float32", "bfloat16"):
        add(phase(f"train_step {dtype}")(phase_train_step)(dtype=dtype))
    ladder_records, ladder_total = phase_ladder()
    records.update(ladder_records)
    add(ladder_total)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ckpt = os.path.join(work, "checkpoints")
        add(phase_trainer(keep_checkpoints=ckpt))
        phase_evaluation(ckpt)
        add(phase_options())
        add(phase_gan())
        add(phase("mesh")(phase_mesh)())
        host, calls, latencies, files_launches = phase_files(ckpt)
        add(files_launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    idle = [name for name, n in calls.items() if n == 0]
    if idle:
        raise AssertionError(f"host routines not called on the file "
                             f"routes: {idle}")
    print(json.dumps({"host_routines": [
        dict(name=name, route="native", source=HOST_SOURCE,
             replaces=HOST_ROUTINES[name]["replaces"], calls=calls[name],
             max_abs_err=0, **host[name]) for name in HOST_ROUTINES],
        "http_ms": {dtype: dict(p50=p50, p99=p99)
                    for dtype, (p50, p99) in latencies.items()}}),
        flush=True)
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
