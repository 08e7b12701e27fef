"""Plain reference of monodepth2's training step and depth inference.

Written from the published method (Godard et al., ICCV 2019,
``nianticlabs/monodepth2``) and the semantics its port keeps: a ResNet-18
depth encoder, the fork's (deconv + BatchNorm) or upstream (nearest 2x)
disparity decoder, a ResNet-18 pose encoder over frame pairs with the
pose decoder, the photometric jitter on the 0..255 grid, back-projection
and projection, bilinear sampling with border clamping, 0.85 SSIM + 0.15
L1, identity automasking with a 1e-5 tie-break, edge-aware smoothness,
and Adam. Images are resized as ``jax.image.resize`` does (separable
weight matrices, half-pixel centres, the kernel widened when shrinking).

Everything is float32 tensor arithmetic, with the networks' convolutions
in the arithmetic of a ``Precision``; parameters are a dict of tensors
named as the monodepth2 ``.pth`` files name them, so the same weights can
be loaded anywhere. It imports nothing but torch and numpy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .precision import Precision

DEC_CH = (16, 32, 64, 128, 256)
ENC_CH = (64, 64, 128, 256, 512)
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


# ---------------------------------------------------------------- layout

def _bn_layout(name, c):
    return [(f"{name}.weight", (c,), "ones", 0.0),
            (f"{name}.bias", (c,), "zeros", 0.0),
            (f"{name}.running_mean", (c,), "zeros", 0.0),
            (f"{name}.running_var", (c,), "ones", 0.0),
            (f"{name}.num_batches_tracked", (), "count", 0.0)]


def _conv_layout(name, cout, cin, k, bias, fan_out_init):
    fan = (cout if fan_out_init else cin) * k * k
    std = math.sqrt((2.0 if fan_out_init else 1.0) / fan)
    out = [(f"{name}.weight", (cout, cin, k, k), "normal", std)]
    if bias:
        out.append((f"{name}.bias", (cout,), "zeros", 0.0))
    return out


def resnet18_layout(prefix: str, in_ch: int):
    """ResNet-18 in torchvision's names; weights normal with variance
    2 / fan_out (kaiming), BatchNorm at identity."""
    out = _conv_layout(f"{prefix}conv1", 64, in_ch, 7, False, True)
    out += _bn_layout(f"{prefix}bn1", 64)
    cin = 64
    for stage in range(1, 5):
        cout = ENC_CH[stage]
        for block in range(2):
            stride = 2 if stage > 1 and block == 0 else 1
            b = f"{prefix}layer{stage}.{block}."
            out += _conv_layout(b + "conv1", cout, cin, 3, False, True)
            out += _bn_layout(b + "bn1", cout)
            out += _conv_layout(b + "conv2", cout, cout, 3, False, True)
            out += _bn_layout(b + "bn2", cout)
            if stride != 1 or cin != cout:
                out += _conv_layout(b + "downsample.0", cout, cin, 1, False,
                                    True)
                out += _bn_layout(b + "downsample.1", cout)
            cin = cout
    return out


def decoder_layout(prefix: str, variant: str, scales: Sequence[int]):
    """The disparity decoder in monodepth2's ``decoder`` ModuleList order
    (the fork: five 2x deconvs first, and ``bn.{i}``); weights normal with
    variance 1 / fan_in, biases 0."""
    if variant not in ("fork", "upstream"):
        raise ValueError(f"unknown decoder variant {variant!r}")
    out, k = [], 0
    if variant == "fork":
        for i in range(4, -1, -1):
            c = DEC_CH[i]
            std = math.sqrt(1.0 / (c * 9))
            out += [(f"{prefix}decoder.{k}.weight", (c, c, 3, 3), "normal",
                     std), (f"{prefix}decoder.{k}.bias", (c,), "zeros", 0.0)]
            k += 1
    for i in range(4, -1, -1):
        cin = ENC_CH[-1] if i == 4 else DEC_CH[i + 1]
        out += _conv_layout(f"{prefix}decoder.{k}.conv.conv", DEC_CH[i], cin,
                            3, True, False)
        skip = ENC_CH[i - 1] if i > 0 else 0
        out += _conv_layout(f"{prefix}decoder.{k + 1}.conv.conv", DEC_CH[i],
                            DEC_CH[i] + skip, 3, True, False)
        k += 2
    for s in sorted(scales):
        out += _conv_layout(f"{prefix}decoder.{k}.conv", 1, DEC_CH[s], 3,
                            True, False)
        k += 1
    if variant == "fork":
        for i in range(5):
            out += _bn_layout(f"{prefix}bn.{i}", DEC_CH[i])
    return out


def pose_decoder_layout(prefix: str):
    out = _conv_layout(f"{prefix}net.0", 256, 512, 1, True, False)
    out += _conv_layout(f"{prefix}net.1", 256, 256, 3, True, False)
    out += _conv_layout(f"{prefix}net.2", 256, 256, 3, True, False)
    out += _conv_layout(f"{prefix}net.3", 12, 256, 1, True, False)
    return out


def layout(variant: str, scales: Sequence[int]):
    """Every parameter and BatchNorm buffer of the depth and pose networks:
    [(name, shape, init, std)], init one of normal, zeros, ones, count."""
    return (resnet18_layout("encoder.encoder.", 3)
            + decoder_layout("depth.", variant, scales)
            + resnet18_layout("pose_encoder.encoder.", 6)
            + pose_decoder_layout("pose."))


def is_parameter(name: str) -> bool:
    """Trained leaves; the rest are BatchNorm buffers."""
    return not name.endswith(("running_mean", "running_var",
                              "num_batches_tracked"))


# ---------------------------------------------------------------- networks

class Nets:
    """The networks over a parameter dict ``P``. ``train`` selects batch
    statistics (updating the running ones in ``P``) over running ones."""

    def __init__(self, P: Dict[str, torch.Tensor], variant: str,
                 scales: Sequence[int], prec: Precision, train: bool):
        self.P, self.variant, self.prec, self.train = P, variant, prec, train
        self.scales = tuple(sorted(scales))

    def bn(self, name, x):
        P = self.P
        w, b = P[name + ".weight"], P[name + ".bias"]
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
            with torch.no_grad():
                for key, v in ((".running_mean", mean), (".running_var",
                                                         var)):
                    P[name + key].mul_(1 - BN_MOMENTUM).add_(
                        BN_MOMENTUM * v.detach())
        else:
            mean, var = P[name + ".running_mean"], P[name + ".running_var"]
        inv = torch.rsqrt(var + BN_EPS)
        scale = (inv * w)[None, :, None, None]
        return (x - mean[None, :, None, None]) * scale + b[None, :, None, None]

    def conv(self, name, x, stride=1, padding=0, reflect=False):
        if reflect:
            x = F.pad(x, (1, 1, 1, 1), mode="reflect")
        return self.prec.conv(x, self.P[name + ".weight"],
                              self.P.get(name + ".bias"), stride, padding)

    def resnet18(self, prefix, x):
        x = F.relu(self.bn(prefix + "bn1", self.conv(prefix + "conv1", x, 2,
                                                       3)))
        feats = [x]
        x = F.max_pool2d(x, 3, 2, 1)
        cin = 64
        for stage in range(1, 5):
            cout = ENC_CH[stage]
            for block in range(2):
                stride = 2 if stage > 1 and block == 0 else 1
                b = f"{prefix}layer{stage}.{block}."
                idt = x
                if stride != 1 or cin != cout:
                    idt = self.bn(b + "downsample.1",
                                  self.conv(b + "downsample.0", x, stride))
                out = F.relu(self.bn(b + "bn1",
                                     self.conv(b + "conv1", x, stride, 1)))
                out = self.bn(b + "bn2", self.conv(b + "conv2", out, 1, 1))
                x = F.relu(out + idt)
                cin = cout
            feats.append(x)
        return feats

    def depth(self, feats, only_scale=None) -> Dict[int, torch.Tensor]:
        """Sigmoid disparities {scale: (B, 1, h, w)}."""
        P, pre = self.P, "depth.decoder."
        fork = self.variant == "fork"
        first = 5 if fork else 0
        heads = first + 10
        out = {}
        x = feats[-1]
        for j, i in enumerate(range(4, -1, -1)):
            x = F.elu(self.conv(f"{pre}{first + 2 * j}.conv.conv", x,
                                reflect=True))
            if fork:
                x = self.prec.deconv(x, P[f"{pre}{j}.weight"],
                                     P[f"{pre}{j}.bias"], 2, 1, 1)
            else:
                x = x.repeat_interleave(2, 2).repeat_interleave(2, 3)
            if i > 0:
                x = torch.cat([x, feats[i - 1]], 1)
            x = F.elu(self.conv(f"{pre}{first + 2 * j + 1}.conv.conv", x,
                                reflect=True))
            if fork:
                x = self.bn(f"depth.bn.{i}", x)
            if i in self.scales and (only_scale is None or i == only_scale):
                k = heads + self.scales.index(i)
                out[i] = torch.sigmoid(self.conv(f"{pre}{k}.conv", x,
                                                 reflect=True))
        return out

    def pose(self, x):
        """Pose network over stacked pairs (N, 6, H, W) -> (axisangle,
        translation) of the first predicted frame, each (N, 3)."""
        f = self.resnet18("pose_encoder.encoder.", x)[-1]
        pre = "pose."
        y = F.relu(self.conv(pre + "net.0", f))
        y = F.relu(self.conv(pre + "net.1", y, 1, 1))
        y = F.relu(self.conv(pre + "net.2", y, 1, 1))
        y = self.conv(pre + "net.3", y).mean(dim=(2, 3))
        y = 0.01 * y.reshape(-1, 2, 6)[:, 0]
        return y[:, :3], y[:, 3:]


# ---------------------------------------------------------------- images

def _resize_kernel(method):
    if method == "bilinear":
        return lambda x: np.maximum(0.0, 1.0 - np.abs(x))

    def lanczos3(x):
        x = np.abs(x)
        with np.errstate(divide="ignore", invalid="ignore"):
            y = 3.0 * np.sin(np.pi * x) * np.sin(np.pi * x / 3.0) / (
                np.pi ** 2 * x ** 2)
        y = np.where(x < 1e-3, 1.0, y)
        return np.where(x > 3.0, 0.0, y)

    return lanczos3


def resize_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_in, n_out) weights: output sample j at input position
    (j + 0.5) * n_in / n_out - 0.5, the kernel stretched by the scale when
    shrinking, each column normalised to sum 1."""
    scale = n_out / n_in
    stretch = max(1.0 / scale, 1.0)
    pos = (np.arange(n_out) + 0.5) / scale - 0.5
    dist = np.abs(pos[None, :] - np.arange(n_in)[:, None]) / stretch
    w = _resize_kernel(method)(dist)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1e-4, w / np.where(total == 0, 1, total), 0)
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_nhwc(x, h: int, w: int, method: str):
    _, hi, wi, _ = x.shape
    if hi != h:
        m = torch.from_numpy(resize_matrix(hi, h, method)).to(x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, m)
    if wi != w:
        m = torch.from_numpy(resize_matrix(wi, w, method)).to(x.device)
        x = torch.einsum("bhwc,wW->bhWc", x, m)
    return x


def pyramid(x, levels: int):
    out = [x]
    for _ in range(1, levels):
        _, h, w, _ = out[-1].shape
        out.append(resize_nhwc(out[-1], h // 2, w // 2, "lanczos3"))
    return out


# ----------------------------------------------------- photometric jitter

def _div(x, d):
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _store(x):
    """A float written to a uint8 image: truncated and clipped."""
    return torch.floor(x).clamp(0.0, 255.0)


def _luma(x):
    """ITU-R 601 grey on the 0..255 grid, in 16-bit fixed point:
    (19595 R + 38470 G + 7471 B + 32768) >> 16."""
    y = (x[..., 0] * (19595.0 / 65536.0) + x[..., 1] * (38470.0 / 65536.0)
         + x[..., 2] * (7471.0 / 65536.0))
    return torch.floor(y + 0.5)[..., None]


def _hsv_roundtrip(x, shift):
    """RGB on the 0..255 grid to hue, saturation and value bytes, the hue
    byte turned by ``shift`` (mod 256), and back."""
    r, g, b = x.unbind(-1)
    v = torch.maximum(torch.maximum(r, g), b)
    lo = torch.minimum(torch.minimum(r, g), b)
    span = v - lo
    nz = span > 0
    den = torch.where(nz, span, torch.ones_like(span))
    rc, gc, bc = (v - r) / den, (v - g) / den, (v - b) / den
    h = torch.where(r == v, bc - gc, torch.where(g == v, 2.0 + rc - bc,
                                                 4.0 + gc - rc))
    h = torch.remainder(_div(h, 6.0) + 1.0, 1.0)
    hb = torch.trunc(h * 255.0)
    sb = torch.where(nz, torch.trunc(span / torch.where(v > 0, v,
                                                        torch.ones_like(v))
                                     * 255.0), torch.zeros_like(v))
    hb = torch.remainder(hb + shift, 256.0)
    h6 = _div(hb * 6.0, 255.0)
    sector = torch.floor(h6)
    frac = h6 - sector
    p = torch.floor(_div(v * (255.0 - sb), 255.0) + 0.5)
    q = torch.floor(_div(v * (255.0 - sb * frac), 255.0) + 0.5)
    t = torch.floor(_div(v * (255.0 - sb * (1.0 - frac)), 255.0) + 0.5)
    sector = torch.remainder(sector, 6.0)
    table = {0: (v, t, p), 1: (q, v, p), 2: (p, v, t), 3: (p, q, v),
             4: (t, p, v), 5: (v, p, q)}
    out = torch.zeros_like(x)
    for k, rgb in table.items():
        out = torch.where((sector == k)[..., None], torch.stack(rgb, -1),
                          out)
    return torch.where((sb == 0)[..., None], v[..., None], out)


def jitter(color, params):
    """uint8 (B, F, H, W, 3) and (B, 6) rows [enabled, brightness,
    contrast, saturation, hue, autocontrast] -> float (B, F, H, W, 3) in
    [0, 1]: brightness, contrast about the frame's mean grey, saturation
    about each pixel's grey, the hue byte turned by int(hue * 255), and a
    per-channel min-max stretch, each stored as a byte; every frame of an
    item gets its item's factors."""
    x = color.float()
    out = []
    for i in range(x.shape[0]):
        on, bright, cont, sat, hue, auto = params[i].tolist()
        xi = x[i]
        if on <= 0.5:
            out.append(xi)
            continue
        y = _store(xi * torch.tensor(bright, device=x.device))
        mean = torch.floor(_luma(y).mean(dim=(1, 2, 3), keepdim=True) + 0.5)
        y = _store(mean + torch.tensor(cont, device=x.device) * (y - mean))
        grey = _luma(y)
        y = _store(grey + torch.tensor(sat, device=x.device) * (y - grey))
        shift = math.trunc(float(np.float32(hue) * np.float32(255.0)))
        if shift != 0:
            y = _store(_hsv_roundtrip(y, float(shift)))
        if auto > 0.5:
            lo = y.amin(dim=(1, 2), keepdim=True)
            hi = y.amax(dim=(1, 2), keepdim=True)
            stretched = torch.floor((y - lo) * 255.0
                                    / (hi - lo).clamp(min=1.0)).clamp(0, 255)
            y = torch.where(hi > lo, stretched, y)
        out.append(y)
    return torch.stack(out) / 255.0


# ---------------------------------------------------------------- geometry

def rodrigues(aa):
    """Axis-angle (N, 3) -> rotation (N, 4, 4)."""
    angle = aa.norm(dim=-1, keepdim=True)
    axis = aa / (angle + 1e-7)
    c, s = torch.cos(angle)[:, 0], torch.sin(angle)[:, 0]
    x, y, z = axis.unbind(-1)
    one_c = 1.0 - c
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    rows = [x * x * one_c + c, x * y * one_c - z * s, z * x * one_c + y * s,
            zero,
            x * y * one_c + z * s, y * y * one_c + c, y * z * one_c - x * s,
            zero,
            z * x * one_c - y * s, y * z * one_c + x * s, z * z * one_c + c,
            zero, zero, zero, zero, one]
    return torch.stack(rows, -1).reshape(-1, 4, 4)


def pose_matrix(aa, t, invert: bool):
    rot = rodrigues(aa)
    if invert:
        rot, t = rot.transpose(1, 2), -t
    trans = torch.eye(4, device=aa.device).repeat(aa.shape[0], 1, 1)
    trans = torch.cat([trans[:, :, :3], torch.cat(
        [t, torch.ones_like(t[:, :1])], 1)[:, :, None]], 2)
    return rot @ trans if invert else trans @ rot


def sample_border(frame, grid):
    """Bilinear sample of NCHW ``frame`` at the [-1, 1] grid (N, 2, H, W)
    (corners aligned), coordinates clamped to the image -> NCHW."""
    n, c, h, w = frame.shape
    x = ((grid[:, 0] + 1.0) * 0.5 * (w - 1)).clamp(0.0, w - 1)
    y = ((grid[:, 1] + 1.0) * 0.5 * (h - 1)).clamp(0.0, h - 1)
    x0 = torch.floor(x).clamp(max=w - 2).detach()
    y0 = torch.floor(y).clamp(max=h - 2).detach()
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    flat = frame.reshape(n, c, h * w)

    def tap(yy, xx):
        idx = (yy * w + xx).long().reshape(n, 1, -1).expand(-1, c, -1)
        return flat.gather(2, idx).reshape(n, c, *x.shape[1:])

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bottom = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bottom * fy


def photometric(pred, target):
    """0.85 * (1 - SSIM) / 2 (3x3 box statistics, reflected border,
    clipped to [0, 1]) + 0.15 * |target - pred|, channel means: NCHW ->
    (N, H, W)."""
    p = F.pad(pred, (1, 1, 1, 1), mode="reflect")
    t = F.pad(target, (1, 1, 1, 1), mode="reflect")
    mp, mt = F.avg_pool2d(p, 3, 1), F.avg_pool2d(t, 3, 1)
    vp = F.avg_pool2d(p * p, 3, 1) - mp * mp
    vt = F.avg_pool2d(t * t, 3, 1) - mt * mt
    cov = F.avg_pool2d(p * t, 3, 1) - mp * mt
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mp * mt + c1) * (2 * cov + c2)) / (
        (mp * mp + mt * mt + c1) * (vp + vt + c2))
    dssim = ((1 - ssim) / 2).clamp(0, 1).mean(1)
    return 0.85 * dssim + 0.15 * (target - pred).abs().mean(1)


def smoothness(disp, img):
    """Edge-aware smoothness of the mean-normalised NHWC disparity."""
    d = disp / (disp.mean(dim=(1, 2), keepdim=True) + 1e-7)
    dx = (d[:, :, :-1] - d[:, :, 1:]).abs()
    dy = (d[:, :-1] - d[:, 1:]).abs()
    ix = (img[:, :, :-1] - img[:, :, 1:]).abs().mean(-1, keepdim=True)
    iy = (img[:, :-1] - img[:, 1:]).abs().mean(-1, keepdim=True)
    return (dx * torch.exp(-ix)).mean() + (dy * torch.exp(-iy)).mean()


# ---------------------------------------------------------------- the step

def _nchw(x):
    return x.permute(0, 3, 1, 2)


def loss(P, opts: dict, batch, noise, prec: Precision):
    """The monodepth2 loss of one batch with BatchNorm on batch statistics:
    batch {'color': uint8 (B, 3, H, W, 3) frames (0, -1, 1), 'K_norm':
    (B, 4, 4), 'aug_params': (B, 6)}, noise {scale: (B, H, W, 2)}."""
    scales = tuple(opts["scales"])
    nets = Nets(P, opts["depth_decoder_variant"], scales, prec, train=True)
    color_u8 = batch["color"]
    b, _, h, w, _ = color_u8.shape
    frames = {0: 0, -1: 1, 1: 2}
    color = {f: color_u8[:, i].float() / 255.0 for f, i in frames.items()}
    aug_all = jitter(color_u8, batch["aug_params"])
    aug = {f: _nchw(aug_all[:, i]) for f, i in frames.items()}
    levels = max(scales) + 1
    pyr = pyramid(color[0], levels)

    disps = nets.depth(nets.resnet18("encoder.encoder.", aug[0]))
    pairs = torch.cat([torch.cat([aug[-1], aug[0]], 1),
                       torch.cat([aug[0], aug[1]], 1)], 0)
    aa, tt = nets.pose(pairs)
    poses = {-1: pose_matrix(aa[:b], tt[:b], True),
             1: pose_matrix(aa[b:], tt[b:], False)}

    K_norm = batch["K_norm"].float()
    K = K_norm.clone()
    K[:, 0] = K_norm[:, 0] * w
    K[:, 1] = K_norm[:, 1] * h
    inv_K = torch.linalg.inv(K)
    ys, xs = torch.meshgrid(torch.arange(h, device=K.device, dtype=K.dtype),
                            torch.arange(w, device=K.device, dtype=K.dtype),
                            indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(h * w, device=K.device)], 0)
    rays = inv_K[:, :3, :3] @ pix
    target = _nchw(color[0])
    with torch.no_grad():
        identity = torch.stack([photometric(_nchw(color[f]), target)
                                for f in (-1, 1)], -1)
    min_disp, max_disp = 1.0 / opts["max_depth"], 1.0 / opts["min_depth"]
    total = 0.0
    for s in scales:
        disp_full = resize_nhwc(disps[s].permute(0, 2, 3, 1), h, w,
                                "bilinear")
        depth = 1.0 / (min_disp + (max_disp - min_disp) * disp_full)
        points = depth.reshape(b, 1, h * w) * rays
        reproj = []
        for f in (-1, 1):
            Pm = (K @ poses[f])[:, :3]
            cam = Pm[:, :, :3] @ points + Pm[:, :, 3:]
            xy = cam[:, :2] / (cam[:, 2:3] + 1e-7)
            scale = torch.tensor([w - 1, h - 1], device=K.device,
                                 dtype=K.dtype)
            grid = (xy.reshape(b, 2, h, w) / scale[:, None, None] - 0.5) * 2
            warped = sample_border(_nchw(color[f]), grid)
            reproj.append(photometric(warped, target))
        combined = torch.cat([identity + noise[s],
                              torch.stack(reproj, -1)], -1)
        term = combined.amin(-1).mean()
        disp_s = disps[s].permute(0, 2, 3, 1)
        term = term + opts["disparity_smoothness"] * smoothness(
            disp_s, pyr[s]) / (2 ** s)
        total = total + term
    return total / len(scales)


class Adam:
    """Adam with bias correction (betas 0.9, 0.999; eps 1e-8)."""

    def __init__(self, params: List[torch.Tensor], lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p.sub_((self.lr / c1) * m / (v.sqrt() / math.sqrt(c2) + eps))


def train(P, opts: dict, batches, noises, prec: Precision, lr: float):
    """Train ``P`` (changed in place) on ``batches`` in turn -> (losses,
    {name: first gradient}). The losses are each step's before its
    update."""
    names = [n for n in P if is_parameter(n)]
    params = [P[n].requires_grad_(True) for n in names]
    adam = Adam(params, lr)
    losses, first = [], None
    with prec.scope():
        for batch, noise in zip(batches, noises):
            total = loss(P, opts, batch, noise, prec)
            grads = torch.autograd.grad(total, params)
            if first is None:
                first = {n: g.detach().clone() for n, g in zip(names, grads)}
            adam.step(grads)
            losses.append(float(total.detach()))
            del total, grads
    for p in params:
        p.requires_grad_(False)
    return losses, first


@torch.no_grad()
def infer(P, opts: dict, images, prec: Precision, block: int = 8):
    """Scale-0 disparity (N, H, W) of uint8 NHWC ``images``, BatchNorm on
    running statistics, in blocks of ``block`` images."""
    nets = Nets(P, opts["depth_decoder_variant"], opts["scales"], prec,
                train=False)
    out = []
    with prec.scope():
        for i in range(0, images.shape[0], block):
            x = _nchw(images[i:i + block].float() / 255.0)
            disp = nets.depth(nets.resnet18("encoder.encoder.", x),
                              only_scale=0)[0]
            out.append(disp[:, 0])
    return torch.cat(out)
