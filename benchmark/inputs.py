"""Inputs made from the run's seed: weights, frames, jitter factors and
the automask's tie-break noise. The same seed gives the same inputs, and
every seed gives inputs of the same sizes. Everything large is drawn on
the run's device in a few calls."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .harness import derive


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def weights(lay: Sequence[Tuple], seed: int, device) -> Dict[str,
                                                             torch.Tensor]:
    """Tensors for a parameter layout [(name, shape, init, std)]: the
    "normal" entries from one draw of N(0, 1) scaled by their std, the
    rest constant (zeros, ones, a zero count)."""
    out = {}
    groups: Dict[str, List[Tuple]] = {}
    for name, shape, init, std in lay:
        groups.setdefault(init, []).append((name, tuple(shape), std))
    normal = groups.get("normal", [])
    sizes = [math.prod(s) for _, s, _ in normal]
    flat = torch.randn(sum(sizes), generator=generator(
        device, derive(seed, "weights")), device=device)
    stds = torch.tensor([std for _, _, std in normal], device=device)
    flat.mul_(torch.repeat_interleave(
        stds, torch.tensor(sizes, device=device)))
    for (name, shape, _), piece in zip(normal, flat.split(sizes)):
        out[name] = piece.view(shape)
    for init, make in (("zeros", torch.zeros), ("ones", torch.ones)):
        entries = groups.get(init, [])
        sizes = [math.prod(s) for _, s, _ in entries]
        flat = make(sum(sizes), device=device)
        for (name, shape, _), piece in zip(entries, flat.split(sizes)):
            out[name] = piece.view(shape)
    entries = groups.get("count", [])
    counts = torch.zeros(len(entries), dtype=torch.int64, device=device)
    for i, (name, _, _) in enumerate(entries):
        out[name] = counts[i]
    return out


def textures(seed: int, tag: str, n: int, frames: Sequence[int], h: int,
             w: int, shift: Tuple[int, int], components: int,
             device) -> np.ndarray:
    """uint8 (n, len(frames), h, w, 3): each of ``n`` smooth random
    textures (a sum of ``components`` sinusoids per channel) seen through
    a window that slides ``shift`` pixels (drawn per texture from the
    inclusive range) per frame index, as a camera translating before a
    plane."""
    g = generator(device, derive(seed, "textures", tag))
    reach = max(abs(int(f)) for f in frames) + 1
    margin = shift[1] * reach
    wide = w + 2 * margin
    freq = 0.01 + 0.14 * torch.rand(n, components, 2, generator=g,
                                    device=device)
    phase = 2 * math.pi * torch.rand(n, components, 3, generator=g,
                                     device=device)
    amp = 0.1 + 0.2 * torch.rand(n, components, 3, generator=g,
                                 device=device)
    steps = torch.randint(shift[0], shift[1] + 1, (n,), generator=g,
                          device=device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(wide, device=device, dtype=torch.float32)[None, :]
    img = torch.zeros(n, h, wide, 3, device=device)
    for k in range(components):
        arg = 2 * math.pi * (freq[:, k, 0, None, None] * xx
                             + freq[:, k, 1, None, None] * yy)
        img += amp[:, k, None, None, :] * torch.sin(
            arg[..., None] + phase[:, k, None, None, :])
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    img = ((img - lo) / (hi - lo).clamp(min=1e-6) * 255.0 + 0.5).to(
        torch.uint8)
    cols = torch.arange(w, device=device)
    views = []
    for f in frames:
        start = margin + int(f) * steps  # (n,)
        idx = (start[:, None] + cols[None, :])[:, None, :, None].expand(
            n, h, w, 3)
        views.append(torch.gather(img, 2, idx))
    return torch.stack(views, 1).cpu().numpy()


def jitter_params(seed: int, epoch: int, index: int, law: dict) -> np.ndarray:
    """(6,) float32 [enabled, brightness, contrast, saturation, hue,
    autocontrast] of one item in one epoch, drawn as torchvision's
    ColorJitter and monodepth2's 50% augmentation are."""
    rng = np.random.default_rng(derive(seed, "jitter", epoch, index))
    if rng.random() >= law["p_enabled"]:
        return np.asarray([0, 1, 1, 1, 0, 0], np.float32)
    b, c, s, hue = (rng.uniform(*law[k]) for k in
                    ("brightness", "contrast", "saturation", "hue"))
    auto = float(rng.random() < law["p_autocontrast"])
    return np.asarray([1, b, c, s, hue, auto], np.float32)


def noise(seed: int, step: int, shape: Tuple[int, ...],
          scales: Sequence[int], device) -> Dict[int, torch.Tensor]:
    """The automask tie-break of training step ``step`` (1-based): 1e-5 *
    N(0, 1) of ``shape`` (B, H, W, sources) for every scale."""
    g = generator(device, derive(seed, "noise", step))
    return {s: torch.randn(shape, generator=g, device=device) * 1e-5
            for s in scales}
