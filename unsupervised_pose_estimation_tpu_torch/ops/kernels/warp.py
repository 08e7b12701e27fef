"""K5, and the warp ladder that ``pallas_warp_version`` selects.

K5: bilinear warp of a uint8 frame plus its coordinate-gradient planes.
CUDA kernel: ``csrc/warp.cu``. It replaces the TPU kernel
``unsupervised_pose_estimation_tpu/ops/pallas/warp_kernel.py::
_warp_lerp_kernel_v8`` and the corner-fetch rungs that back it up under
large motion. On an H100 it is bound by bytes: 69.3 MB at B=12, C=3,
192x640, 20.7 us at 3.35 TB/s.

The ladder: ``grid_sample_fast`` ports the JAX package's
``grid_sample_fast`` and its dispatch ladder ``_sample_impl``. At version 8
and above a uint8 frame goes through K5, which is exact at any displacement
and so has no rung beneath it. At versions 1-7, and for float frames at
any version, the warp fetches its four corner planes through the first
rung, in the reference's order, whose gate holds: the version's top rung
(K6 ``fetch_corners`` at 1-5, K7 at 6, K8 at 7), then K6 as the v4, v3 and
wide-band v3 rungs beneath it, then a plain gather. Every rung returns the
exact bilinear taps where its gate holds, so the rung changes the speed,
not the values. The gates of one call are read to the host together, once
(one synchronisation per warp), and ``_lib.RUNGS`` counts the rung that
ran. A rung is chosen by its gate alone: a kernel that fails raises.

``Warp`` is the differentiable warp of both, with the JAX package's
``_sample_planar`` gradient: the upstream gradient contracted with the
ddx / ddy planes (plain PyTorch, as the JAX backward is XLA), none to the
image.
"""

from __future__ import annotations

import torch

from ... import tracing
from ..warp import corners, grid_cotangent, unnormalize
from . import _lib
from .corners import (LANE, MB7, expand_starts, fetch_corners,
                      fetch_corners_packed, fetch_corners_packed_v7,
                      gather_taps)

INV255 = 1.0 / 255.0
BAND_H = 40       # rows of the band of the v1, v3, v4, v5 and v6 rungs
WIDE_BAND_H = 72  # rows of the wide-band v3 rung
RB = 8            # output rows per band start (v1, v3, v4, v5)
RBP = 16          # output rows per band start (v6)
MB = 16           # rows of v2's per-row miniband


def _check(image, grid):
    b, h, w, _ = image.shape
    if image.dtype != torch.uint8:
        raise TypeError(f"warp: image must be uint8, got {image.dtype}")
    if grid.dtype != torch.float32 or tuple(grid.shape) != (b, 2, h, w):
        raise ValueError(f"warp: grid must be float32 {(b, 2, h, w)}, got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    if h < 2 or w < 2:
        raise ValueError("warp: image must be at least 2x2")


def lerp_planes(image, grid):
    """The warp's arithmetic on NHWC float corners -> (warped, ddx, ddy),
    each (B, H, W, C) in [0, 1] units."""
    _, h, w, _ = image.shape
    x, y = unnormalize(grid[:, 0], grid[:, 1], h, w)
    v00, v01, v10, v11, wx, wy = corners(image, x, y)
    dtop = v01 - v00
    dbot = v11 - v10
    top = v00 + wx * dtop
    bot = v10 + wx * dbot
    warped = (top + wy * (bot - top)) * INV255
    ddx = (dtop + wy * (dbot - dtop)) * INV255
    ddy = (bot - top) * INV255
    return warped, ddx, ddy


def warp_plain(image, grid):
    """Plain PyTorch version of the kernel: image (B, H, W, C) uint8, planar
    grid (B, 2, H, W) in [-1, 1] (border, align_corners=True) -> warped,
    d warped / d x and d warped / d y, each planar (B, C, H, W) float32 in
    [0, 1] units (the lerp runs on raw 0..255 values and is scaled last)."""
    _check(image, grid)
    return tuple(t.permute(0, 3, 1, 2).contiguous()
                 for t in lerp_planes(image, grid))


def warp(image, grid):
    """The warp of :func:`warp_plain`: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    _check(image, grid)
    if not _lib.on_cuda("warp", image, grid):
        return warp_plain(image, grid)
    b, h, w, c = image.shape
    warped, ddx, ddy = (torch.empty((b, c, h, w), dtype=torch.float32,
                                    device=image.device) for _ in range(3))
    with torch.cuda.device(image.device):
        _lib.launch("warp", "upe_warp", image.data_ptr(), grid.data_ptr(),
                    warped.data_ptr(), ddx.data_ptr(), ddy.data_ptr(),
                    b, h, w, c, _lib.stream_of(image))
    return warped, ddx, ddy


def _band(lo, hi, h, band):
    """Band starts ``clip((lo // 8) * 8, 0, h - band)`` for blocks whose top
    taps span rows [lo, hi], and the gate: every block's taps, top and
    bottom, inside its band."""
    ymin = torch.clamp(torch.div(lo, 8, rounding_mode="floor") * 8, 0,
                       h - band)
    return ymin, torch.all(hi + 1 - ymin <= band - 1)


def ladder(version, uint8, x0i, y0i, h, w):
    """The rungs above the gather of ``version``'s ladder, top first, as
    ``_sample_impl`` orders and gates them: a list of (name, ymin (B, H /
    rows, W / cols) band starts, band rows, gate as a 0-d bool tensor)."""
    b = x0i.shape[0]
    if version == 2:
        ymin, ok = _band(y0i.amin(2), y0i.amax(2), h, MB)
        return [("v2", ymin[..., None], MB, ok)]
    band_h = min(BAND_H, h)
    blocks = y0i.reshape(b, h // RB, RB * w)
    lo, hi = blocks.amin(2), blocks.amax(2)
    ymin, band_ok = _band(lo, hi, h, band_h)
    ymin = ymin[..., None]
    rungs = []
    if version >= 4:
        # every x-tap within one 128-column group of its output column
        group = torch.arange(w, device=x0i.device) // LANE
        shift_ok = torch.logical_and(
            torch.all(torch.div(x0i, LANE, rounding_mode="floor")
                      - group >= -1),
            torch.all(torch.div(x0i + 1, LANE, rounding_mode="floor")
                      - group <= 1))
        if version == 6 and uint8 and h % RBP == 0:
            y6 = y0i.reshape(b, h // RBP, RBP * w)
            m6, ok6 = _band(y6.amin(2), y6.amax(2), h, band_h)
            rungs.append(("v6", m6[..., None], band_h, ok6 & shift_ok))
        if (version == 7 and uint8 and h % RBP == 0 and h >= MB7
                and w % LANE == 0):
            y7 = y0i.reshape(b, h, w // LANE, LANE)
            m7, ok7 = _band(y7.amin(3), y7.amax(3), h, MB7)
            rungs.append(("v7", m7, MB7, ok7 & shift_ok))
        rungs.append(("v5" if version == 5 else "v4", ymin, band_h,
                      band_ok & shift_ok))
        rungs.append(("v3", ymin, band_h, band_ok))
    else:
        rungs.append((f"v{version}", ymin, band_h, band_ok))
    if h > WIDE_BAND_H:
        ymin_w, ok_w = _band(lo, hi, h, WIDE_BAND_H)
        rungs.append(("v3_wide", ymin_w[..., None], WIDE_BAND_H, ok_w))
    return rungs


def frame_planes(image):
    """(B, H, W, C) frame -> (B, C, H, W) float32 planes, uint8 scaled to
    [0, 1] (the per-plane rungs and the gather work on scaled values)."""
    img = image.float()
    if image.dtype == torch.uint8:
        img = img * INV255
    return img.permute(0, 3, 1, 2).contiguous()


def corners_to_triple(v00, v01, v10, v11, wx, wy):
    """The lerp of ``_sample_impl``, in its operation order: four (B, C, H,
    W) corner planes and the (B, 1, H, W) weights -> warped, ddx, ddy."""
    dtop = v01 - v00
    dbot = v11 - v10
    top = v00 + dtop * wx
    bot = v10 + dbot * wx
    warped = top + (bot - top) * wy
    ddx = dtop + (dbot - dtop) * wy
    ddy = bot - top
    return warped, ddx, ddy


def _check_ladder(image, grid, version):
    b, h, w, _ = image.shape
    if version < 1:
        raise ValueError(f"warp ladder: version {version} < 1")
    if image.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"warp ladder: image must be uint8 or float32, got "
                        f"{image.dtype}")
    if grid.dtype != torch.float32 or tuple(grid.shape) != (b, 2, h, w):
        raise ValueError(f"warp ladder: grid must be float32 {(b, 2, h, w)}, "
                         f"got {grid.dtype} {tuple(grid.shape)}")
    if w % LANE or h % RB or h < 16:
        raise ValueError(f"warp ladder: needs W % 128 == 0, H % 8 == 0 and "
                         f"H >= 16, got {h}x{w}; use ops.warp.grid_sample")


def taps(grid):
    """Planar grid (B, 2, H, W) -> the top-left tap's column and row (B, H,
    W) int32 and the lerp weights (B, 1, H, W), as ``_sample_impl`` takes
    them."""
    _, _, h, w = grid.shape
    x, y = unnormalize(grid[:, 0], grid[:, 1], h, w)
    x0 = torch.clamp(torch.floor(x), max=w - 2)
    y0 = torch.clamp(torch.floor(y), max=h - 2)
    return x0.int(), y0.int(), (x - x0)[:, None], (y - y0)[:, None]


def sample(image, grid, version):
    """Warp ``image`` (B, H, W, C) uint8 or float32 at the planar grid (B, 2,
    H, W) in [-1, 1] (border, align_corners=True) through ``version``'s
    ladder -> warped, ddx, ddy, each (B, C, H, W) float32 (uint8 frames in
    [0, 1] units)."""
    b, h, w, c = image.shape
    if version >= 8 and image.dtype == torch.uint8:
        out = warp(image, grid)
        _lib.count_rung("v8")
        return out
    _check_ladder(image, grid, version)
    x0i, y0i, wx, wy = taps(grid)
    rungs = ladder(version, image.dtype == torch.uint8, x0i, y0i, h, w)
    with tracing.span("warp.ladder_gates"):
        oks = torch.stack([r[3] for r in rungs]).tolist()
    chosen = next((r for r, ok in zip(rungs, oks) if ok), None)
    if chosen is None:
        # the reference's exact XLA patch gather; no Pallas kernel there
        idx = (y0i * w + x0i).reshape(b, h * w).long()
        quad = gather_taps(frame_planes(image).reshape(b, c, h * w), idx, w)
        name = "gather"
    else:
        name, ymin, band, _ = chosen
        yl = y0i - expand_starts(ymin, h, w)
        if name in ("v6", "v7"):
            # raw 0..255 bfloat16 corners, scaled after the fetch
            quad = (fetch_corners_packed(image, x0i, yl, ymin, band)
                    if name == "v6" else
                    fetch_corners_packed_v7(image, x0i, yl, ymin))
            quad = [t.float() * INV255 for t in quad]
        else:
            quad = fetch_corners(frame_planes(image).reshape(b * c, h, w),
                                 x0i, yl, ymin, band)
    _lib.count_rung(name)
    return corners_to_triple(*(t.reshape(b, c, h, w) for t in quad), wx, wy)


class Warp(torch.autograd.Function):
    """:func:`sample` forward; backward gx = sum_c g * ddx,
    gy = sum_c g * ddy, then through the coordinate clamp to the grid. The
    image gets no gradient (the JAX package's ``_sample_planar``
    custom_vjp)."""

    @staticmethod
    def forward(ctx, image, grid, version):
        warped, ddx, ddy = sample(image, grid, version)
        ctx.save_for_backward(grid, ddx, ddy)
        ctx.mark_non_differentiable(ddx, ddy)
        return warped, ddx, ddy

    @staticmethod
    def backward(ctx, grad, _grad_ddx, _grad_ddy):
        grid, ddx, ddy = ctx.saved_tensors
        gx = torch.sum(grad * ddx, dim=1)
        gy = torch.sum(grad * ddy, dim=1)
        return None, grid_cotangent(grid, gx, gy), None


def warp_op(image, grid):
    """Differentiable :func:`warp` (gradient to the grid only): K5
    forward, a plain-torch backward."""
    return Warp.apply(image, grid, 8)


def grid_sample_fast(image, grid, planar_out=False, version=8,
                     planar_grid=False):
    """Bilinear sample with ``F.grid_sample(padding_mode="border",
    align_corners=True)`` semantics through ``version``'s ladder, with
    exact coordinate gradients and none to the image (the JAX package's
    ``grid_sample_fast``).

    image: (B, H, W, C) uint8 or float32; grid: (B, H, W, 2) in [-1, 1], or
    (B, 2, H, W) with ``planar_grid``. Below version 8, and for float
    frames, needs W % 128 == 0, H % 8 == 0 and H >= 16. Returns (B, H, W,
    C) float32, or (B, C, H, W) with ``planar_out``; uint8 frames give
    [0, 1] values."""
    if not planar_grid:
        grid = grid.permute(0, 3, 1, 2)
    out = Warp.apply(image, grid.contiguous(), version)[0]
    return out if planar_out else out.permute(0, 2, 3, 1)
