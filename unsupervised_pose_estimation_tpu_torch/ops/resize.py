"""Resizing with the semantics of ``jax.image.resize``.

Port of ``unsupervised_pose_estimation_tpu/ops/resize.py``. ``jax.image.resize``
is a separable weighted sum: one (in, out) weight matrix per resized axis,
built from the method's kernel with half-pixel centres and, on downsampling,
the kernel stretched by the scale (antialiasing). Building the same matrices
and contracting with them reproduces it; ``F.interpolate`` has no lanczos3
and does not antialias. Layouts are NHWC, as in the reference, apart from
``upsample2x_nearest``, which serves the networks and takes their NCHW.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _lanczos3(x):
    radius = 3.0
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    den = np.where(x != 0, np.pi ** 2 * x ** 2, 1.0)
    out = np.where(x > 1e-3, y / den, 1.0)
    return np.where(x > radius, 0.0, out)


_KERNELS = {"bilinear": _triangle, "lanczos3": _lanczos3}


@functools.lru_cache(maxsize=64)
def _weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(in_size, out_size) float32 weights of jax's compute_weight_mat."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = _KERNELS[method]((x / kernel_scale).astype(f32)).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0.0).astype(f32)
    w.setflags(write=False)
    return w


def resize(x, height: int, width: int, method: str):
    """Resize NHWC ``x`` to (height, width) like ``jax.image.resize``."""
    _, h, w, _ = x.shape
    if h != height:
        wy = torch.tensor(_weights(h, height, method), device=x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, wy)
    if w != width:
        wx = torch.tensor(_weights(w, width, method), device=x.device)
        x = torch.einsum("bhwc,wW->bhWc", x, wx)
    return x


def resize_bilinear(x, height: int, width: int):
    """Bilinear resize of NHWC ``x``, half-pixel centres (PyTorch's
    align_corners=False when upsampling)."""
    return resize(x, height, width, "bilinear")


def upsample2x_nearest(x):
    """2x nearest upsample of NCHW ``x`` (the upstream monodepth2 decoder's,
    the reference's ``upsample2x_nearest`` on NHWC): a broadcast and a
    reshape, so its backward is the sum over each 2x2 block, a reduction in
    a fixed order (no scatter, no atomics)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(
        b, c, 2 * h, 2 * w)


def image_pyramid(x, num_scales: int):
    """Chained lanczos3 halvings of NHWC ``x``: level s is
    (H / 2^s, W / 2^s)."""
    pyr = [x]
    for _ in range(1, num_scales):
        _, h, w, _ = pyr[-1].shape
        pyr.append(resize(pyr[-1], h // 2, w // 2, "lanczos3"))
    return pyr

