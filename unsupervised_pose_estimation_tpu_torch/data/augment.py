"""Host-side photometric augmentation.

Port of ``unsupervised_pose_estimation_tpu/data/augment.py``: ColorJitter
(brightness, contrast, saturation 0.8-1.2, hue +-0.1) and autocontrast,
drawn once per item and applied identically to all its frames, in a fixed
order (brightness, contrast, saturation, hue). With ``device_augment`` (the
default) only the drawn factors travel (``AugmentParams.to_vector``) and the
training step applies them on the device (``ops.augment_device``);
``apply_augment`` is the host path and needs PIL, which it imports when an
item is augmented.
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


def apply_augment(frame: np.ndarray, p: AugmentParams) -> np.ndarray:
    """(H, W, 3) uint8 -> the jittered frame, through PIL as the reference
    package does (bit-identical to it)."""
    if not p.enabled:
        return frame
    from PIL import Image, ImageEnhance, ImageOps

    img = Image.fromarray(frame)
    img = ImageEnhance.Brightness(img).enhance(p.brightness)
    img = ImageEnhance.Contrast(img).enhance(p.contrast)
    img = ImageEnhance.Color(img).enhance(p.saturation)
    if p.hue != 0.0:
        hsv = np.array(img.convert("HSV"), dtype=np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(p.hue * 255)) % 256
        img = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
    if p.autocontrast:
        img = ImageOps.autocontrast(img)
    return np.asarray(img, np.uint8)
