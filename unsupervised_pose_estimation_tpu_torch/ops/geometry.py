"""Camera geometry: disparity to depth, SE(3) from axis-angle, back-projection
and projection.

Port of ``unsupervised_pose_estimation_tpu/ops/geometry.py``, in the forms
the step uses; layouts are the reference's (depth (B, H, W, 1), points
(B, 3, H*W), planar coordinates (B, 2, H, W)). The small camera matmuls run in float32: callers keep
``torch.backends.cuda.matmul.allow_tf32`` off, its default.
"""

from __future__ import annotations

import torch


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Sigmoid output in [0, 1] -> (scaled_disp, depth) in
    [1/max_depth, 1/min_depth] and its inverse."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def depth_to_disp(depth, min_disp: float = 0.00001,
                  max_disp: float = 1.000001):
    """The GAN prior's inverse of ``disp_to_depth``: a normalised depth in
    [0, 1] (the generator's tanh output, negative where it is below 0) ->
    (scaled_depth, disp) in [1/max_disp, 1/min_disp] and its inverse."""
    min_depth = 1.0 / max_disp
    max_depth = 1.0 / min_disp
    scaled_depth = min_depth + (max_depth - min_depth) * depth
    return scaled_depth, 1.0 / scaled_depth


def rot_from_axisangle(vec):
    """Axis-angle (B, 3) -> rotation as (B, 4, 4), Rodrigues with the
    reference's 1e-7 guard on the angle."""
    angle = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    c = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xc, yc, zc = x * c, y * c, z * c
    xyc, yzc, zxc = x * yc, y * zc, z * xc
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    rot = torch.stack([
        x * xc + ca, xyc - zs, zxc + ys, zeros,
        xyc + zs, y * yc + ca, yzc - xs, zeros,
        zxc - ys, yzc + xs, z * zc + ca, zeros,
        zeros, zeros, zeros, ones,
    ], dim=-1)
    return rot.reshape(vec.shape[:-1] + (4, 4))


def get_translation_matrix(translation):
    """Translation (B, 3) -> (B, 4, 4) homogeneous matrix."""
    eye = torch.eye(4, dtype=translation.dtype, device=translation.device)
    t = eye.expand(translation.shape[:-1] + (4, 4)).clone()
    t[..., :3, 3] = translation
    return t


def transformation_from_parameters(axisangle, translation, invert=False):
    """(axis-angle, translation) -> (B, 4, 4): T @ R, or R^T @ T(-t) when
    ``invert``."""
    rot = rot_from_axisangle(axisangle)
    if invert:
        rot = rot.transpose(-1, -2)
        translation = -translation
    trans = get_translation_matrix(translation)
    return rot @ trans if invert else trans @ rot


def pixel_grid(height: int, width: int, device=None):
    """Homogeneous pixel grid (3, H*W): rows x, y, 1."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones(height * width, device=device)], 0)


def backproject(depth, inv_K):
    """Depth (B, H, W, 1) and inverse intrinsics (B, 4, 4) -> camera points
    (B, 3, H*W), the homogeneous ones row left implicit (the reference's
    ``homogeneous=False``)."""
    b, h, w, _ = depth.shape
    rays = inv_K[:, :3, :3] @ pixel_grid(h, w, device=depth.device)
    return depth.reshape(b, 1, h * w) * rays


def project(points, K, T, height: int, width: int, eps: float = 1e-7):
    """Camera points (B, 3, H*W) through pose T and intrinsics K ->
    planar sampling coordinates (B, 2, H, W) in [-1, 1], align_corners=True
    (the reference's ``planar=True``)."""
    P = (K @ T)[:, :3, :]
    cam = P[:, :, :3] @ points + P[:, :, 3:4]
    xy = cam[:, :2] / (cam[:, 2:3] + eps)
    scale = torch.tensor([width - 1, height - 1], dtype=points.dtype,
                         device=points.device)
    pix = xy.reshape(points.shape[0], 2, height, width)
    return (pix / scale[:, None, None] - 0.5) * 2.0


def scaled_intrinsics(K_norm, width: int, height: int, scale: int):
    """Resolution-normalised K (B, 4, 4) -> pixel-unit K at pyramid level
    ``scale``."""
    mult = torch.ones(4, dtype=K_norm.dtype, device=K_norm.device)
    mult[0] = width // (2 ** scale)
    mult[1] = height // (2 ** scale)
    return K_norm * mult[None, :, None]


def invert_intrinsics(K):
    """Closed-form inverse of a pinhole K (B, 4, 4)."""
    fx, fy = K[:, 0, 0], K[:, 1, 1]
    cx, cy = K[:, 0, 2], K[:, 1, 2]
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    inv = torch.stack([
        1.0 / fx, zeros, -cx / fx, zeros,
        zeros, 1.0 / fy, -cy / fy, zeros,
        zeros, zeros, ones, zeros,
        zeros, zeros, zeros, ones,
    ], dim=-1)
    return inv.reshape(K.shape[0], 4, 4)
