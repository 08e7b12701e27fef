"""Device-side photometric augmentation of a training batch.

Port of ``unsupervised_pose_estimation_tpu/ops/augment_device.py::
batch_augment`` in its unpacked form (the packed space-to-depth form there
is a TPU layout rewrite with the same values). The host ships uint8 frames
plus six floats per item, and the step synthesises ``color_aug`` from them.
Stage by stage, as PIL does it, with the values kept on the 0..255 grid and
truncated after every stage:

  brightness   x * b
  contrast     m + c * (x - m), m = round(mean(L)) per frame
  saturation   L + s * (x - L), L = PIL luma per pixel
  hue          HSV rotation by int(hue * 255) uint8 H units, skipped at 0
  autocontrast per-channel, per-frame (x - lo) * 255 / (hi - lo)
"""

from __future__ import annotations

import torch

# PIL L-convert weights: (19595 R + 38470 G + 7471 B + 0x8000) >> 16
_LW = (19595.0 / 65536.0, 38470.0 / 65536.0, 7471.0 / 65536.0)

def _div(x, d: float):
    """x / d, rounded as an IEEE division on every device: CUDA divides by
    a Python scalar as a multiply by its reciprocal, which rounds
    differently and can move a value across the floor that follows."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _r8(x):
    """PIL's float -> uint8 store: truncation, clipped to 0..255."""
    return torch.clamp(torch.floor(x), 0.0, 255.0)


def _lum(x):
    """PIL 'L' conversion of 0..255 float RGB, (..., 3) -> (..., 1)."""
    lum = x[..., 0] * _LW[0] + x[..., 1] * _LW[1] + x[..., 2] * _LW[2]
    return torch.floor(lum + 0.5)[..., None]


def _select(idx, values):
    """values[idx] elementwise, idx an integer tensor in [0, len(values))."""
    out = values[-1]
    for k in range(len(values) - 2, -1, -1):
        out = torch.where(idx == k, values[k], out)
    return out


def _hue_rotate(x, shift_u8):
    """Rotate hue by ``shift_u8`` uint8 H units (mod 256) through PIL's
    uint8 RGB -> HSV -> RGB roundtrip: H and S truncated to the uint8 grid
    on the way in, each channel rounded on the way out, and S == 0 pixels
    returned as gray(V). x is (..., 3) float on the 0..255 grid."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    safe_c = torch.where(c > 0, c, 1.0)
    safe_mx = torch.where(mx > 0, mx, 1.0)
    rc = (mx - r) / safe_c
    gc = (mx - g) / safe_c
    bc = (mx - b) / safe_c
    h = torch.where(r == mx, bc - gc,
                    torch.where(g == mx, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(_div(h, 6.0) + 1.0, 1.0)
    uh = torch.trunc(h * 255.0)
    us = torch.where(c > 0, torch.trunc(c / safe_mx * 255.0), 0.0)

    uh = torch.remainder(uh + shift_u8[..., 0], 256.0)
    v = mx
    h6 = _div(uh * 6.0, 255.0)
    i = torch.floor(h6)
    f = h6 - i
    p = torch.floor(_div(v * (255.0 - us), 255.0) + 0.5)
    q = torch.floor(_div(v * (255.0 - us * f), 255.0) + 0.5)
    t = torch.floor(_div(v * (255.0 - us * (1.0 - f)), 255.0) + 0.5)
    i = torch.remainder(i.to(torch.int32), 6)
    r2 = _select(i, [v, q, p, p, t, v])
    g2 = _select(i, [t, v, v, q, p, p])
    b2 = _select(i, [p, p, t, v, v, q])
    out = torch.stack([r2, g2, b2], dim=-1)
    return torch.where((us == 0.0)[..., None], v[..., None], out)


def batch_augment(color, params):
    """color: (B, F, H, W, 3) uint8 (or float in [0, 1]); params: (B, 6)
    float32 rows [enabled, brightness, contrast, saturation, hue,
    autocontrast]. Returns float32 (B, F, H, W, 3) in [0, 1]: every frame of
    an item gets the item's factors; rows with enabled <= 0.5 pass through
    unchanged."""
    x = color.float()
    if color.dtype != torch.uint8:
        x = x * 255.0
    params = params.float()

    def bc(v):  # (B,) -> (B, 1, 1, 1, 1)
        return v.reshape((-1,) + (1,) * (x.dim() - 1))

    enabled = bc((params[:, 0] > 0.5).float())
    bright = bc(params[:, 1])
    cont = bc(params[:, 2])
    sat = bc(params[:, 3])
    hue = params[:, 4]
    auto = bc((params[:, 5] > 0.5).float()) * enabled

    y = _r8(x * bright)
    # per-frame mean of the L image (ImageEnhance.Contrast's gray level)
    mean = torch.floor(torch.mean(_lum(y), dim=(2, 3, 4), keepdim=True)
                       + 0.5)
    y = _r8(mean + cont * (y - mean))
    y = _r8(_lum(y) + sat * (y - _lum(y)))
    # int(hue * 255) truncates toward zero; a zero shift skips the stage
    # (the uint8 HSV roundtrip alone is not the identity)
    shift = torch.trunc(hue * 255.0)
    rotated = _r8(_hue_rotate(y, bc(shift)))
    y = torch.where(bc(shift) != 0.0, rotated, y)
    # autocontrast, cutoff 0: per-channel, per-frame min/max stretch
    lo = torch.amin(y, dim=(2, 3), keepdim=True)
    hi = torch.amax(y, dim=(2, 3), keepdim=True)
    stretch = torch.clamp(torch.floor((y - lo) * 255.0
                                      / torch.clamp(hi - lo, min=1.0)),
                          0.0, 255.0)
    y = torch.where(hi > lo, stretch, y) * auto + y * (1.0 - auto)

    return (y * enabled + x * (1.0 - enabled)) * (1.0 / 255.0)
