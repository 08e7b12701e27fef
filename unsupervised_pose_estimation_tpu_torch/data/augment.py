"""Host-side photometric augmentation.

Port of ``unsupervised_pose_estimation_tpu/data/augment.py``: ColorJitter
(brightness, contrast, saturation 0.8-1.2, hue +-0.1) and autocontrast,
drawn once per item and applied identically to all its frames, in a fixed
order (brightness, contrast, saturation, hue). With ``device_augment`` (the
default) only the drawn factors travel (``AugmentParams.to_vector``) and the
training step applies them on the device (``ops.augment_device``);
``apply_augment`` is the host path, in numpy with PIL's bytes: its
``ImageEnhance`` blends (``Image.blend``, float32), its RGB <-> HSV
conversions (``Convert.c``) and ``ImageOps.autocontrast``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AugmentParams:
    enabled: bool
    brightness: float = 1.0
    contrast: float = 1.0
    saturation: float = 1.0
    hue: float = 0.0
    autocontrast: bool = False

    @classmethod
    def draw(cls, rng: np.random.Generator, is_train: bool) -> "AugmentParams":
        if not is_train or rng.random() <= 0.5:
            return cls(enabled=False)
        return cls(
            enabled=True,
            brightness=float(rng.uniform(0.8, 1.2)),
            contrast=float(rng.uniform(0.8, 1.2)),
            saturation=float(rng.uniform(0.8, 1.2)),
            hue=float(rng.uniform(-0.1, 0.1)),
            autocontrast=bool(rng.random() < 0.5),
        )

    def to_vector(self) -> np.ndarray:
        """(6,) float32 for ``ops.augment_device.batch_augment``: enabled,
        brightness, contrast, saturation, hue, autocontrast."""
        return np.asarray(
            [1.0 if self.enabled else 0.0, self.brightness, self.contrast,
             self.saturation, self.hue, 1.0 if self.autocontrast else 0.0],
            np.float32)


def _blend(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    """PIL's ``Image.blend(a, b, alpha)`` of uint8 arrays: a + alpha * (b -
    a) in float32, truncated (clipped to 0..255 when alpha is outside
    [0, 1]); alpha 0 and 1 copy."""
    alpha = np.float32(alpha)
    if alpha == 0:
        return a
    if alpha == 1:
        return b
    a32 = a.astype(np.float32)
    out = a32 + alpha * (b.astype(np.float32) - a32)
    if not 0 <= alpha <= 1:
        out = np.clip(out, 0, 255)
    return out.astype(np.uint8)


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")``: (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """PIL's ``convert("HSV")`` (rgb2hsv_row): float32 ratios, the hue's
    sums and its wrap in double, each stored value truncated."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    flat = mx == mn
    cr = np.where(flat, 1, mx - mn).astype(np.float32)
    s = cr / np.where(mx == 0, 1, mx).astype(np.float32)
    rc, gc, bc = ((mx - c).astype(np.float32) / cr for c in (r, g, b))
    h = np.where(r == mx, (bc - gc).astype(np.float64),
                 np.where(g == mx, 2.0 + rc.astype(np.float64) - bc,
                          4.0 + gc.astype(np.float64) - rc))
    h = np.fmod(h.astype(np.float32).astype(np.float64) / 6.0 + 1.0, 1.0)
    h = h.astype(np.float32).astype(np.float64)
    uh = np.clip((h * 255.0).astype(np.int64), 0, 255)
    us = np.clip((s.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    return np.stack([np.where(flat, 0, uh), np.where(flat, 0, us), mx],
                    -1).astype(np.uint8)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """PIL's HSV -> ``convert("RGB")`` (hsv2rgb): the sector and its
    remainder in double, the remainder and the saturation stored as float32,
    each channel rounded half away from zero."""
    h, s, v = (hsv[..., i].astype(np.float64) for i in range(3))
    h6 = h.astype(np.float32).astype(np.float64) * 6.0 / 255.0
    i = np.floor(h6)
    f = (h6 - i).astype(np.float32)
    fs = (s / 255.0).astype(np.float32)

    def rnd(x):
        return np.clip(np.sign(x) * np.floor(np.abs(x) + 0.5), 0, 255)

    p = rnd(v * (1.0 - fs.astype(np.float64)))
    q = rnd(v * (1.0 - (fs * f).astype(np.float64)))
    t = rnd(v * (1.0 - fs.astype(np.float64)
                 * (1.0 - f.astype(np.float64))))
    sector = i.astype(np.int64) % 6
    choices = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
               (v, p, q)]
    out = np.stack([np.choose(sector, [c[k] for c in choices])
                    for k in range(3)], -1)
    out = np.where((s == 0)[..., None], v[..., None], out)
    return out.astype(np.uint8)


def _autocontrast(rgb: np.ndarray) -> np.ndarray:
    """PIL's ``ImageOps.autocontrast`` (cutoff 0): each channel's lowest
    and highest values stretched to 0..255 through a lookup table built in
    double, a flat channel left as it is."""
    out = np.empty_like(rgb)
    for c in range(rgb.shape[-1]):
        x = rgb[..., c]
        lo, hi = int(x.min()), int(x.max())
        if hi <= lo:
            out[..., c] = x
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        lut = np.clip((np.arange(256) * scale + offset).astype(np.int64), 0,
                      255).astype(np.uint8)
        out[..., c] = lut[x]
    return out


def apply_augment(frame: np.ndarray, p: AugmentParams) -> np.ndarray:
    """(H, W, 3) uint8 -> the jittered frame, the bytes of the reference
    package's PIL pipeline (``ImageEnhance`` brightness, contrast and
    colour, the HSV hue shift by ``int(hue * 255)`` mod 256, then
    ``ImageOps.autocontrast``)."""
    if not p.enabled:
        return frame
    img = _blend(np.zeros_like(frame), frame, p.brightness)
    # Contrast's degenerate image: the grey mean of the frame, rounded
    hist = np.bincount(_luma(img).ravel(), minlength=256)
    mean = int(float((np.arange(256) * hist).sum()) / hist.sum() + 0.5)
    img = _blend(np.full_like(img, mean), img, p.contrast)
    img = _blend(np.repeat(_luma(img)[..., None], 3, -1), img, p.saturation)
    if p.hue != 0.0:
        hsv = _rgb_to_hsv(img).astype(np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(p.hue * 255)) % 256
        img = _hsv_to_rgb(hsv.astype(np.uint8))
    if p.autocontrast:
        img = _autocontrast(img)
    return img
