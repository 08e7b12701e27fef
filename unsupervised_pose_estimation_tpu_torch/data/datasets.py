"""Datasets: endoscopy (lung/phantom, SCARED), KITTI, and two procedural
sets (no files) for tests and benchmarks.

Port of ``unsupervised_pose_estimation_tpu/data/datasets.py``. An item is a
dict of numpy arrays, frames on a leading axis in ``frame_idxs`` order
(then "s" if stereo):

    color      (F, H, W, 3) uint8, geometric flip applied
    color_aug  (F, H, W, 3) uint8, the same flip plus the photometric jitter
               (only without device_augment)
    aug_params (6,) float32 jitter factors (only with device_augment; the
               training step applies them on the device)
    K_norm     (4, 4) float32, resolution-normalized intrinsics
    stereo_T   (4, 4) float32, only when "s" in frame_idxs
    depth_gt   (H0, W0) float32, only when the dataset has ground truth and
               load_depth is set

Items are bit-identical to the reference package's for the same seed. The
file datasets read their frames from an attached frame cache
(``data.cache``) when there is one; otherwise they decode PNG frames with
``data.png`` and resize them with ``data.resample.resize_lanczos`` (PIL's
bytes, without PIL), through the native host routines when ``native`` is
set (the trainer and the evaluation set it on a CUDA device) and numpy
otherwise. PIL is imported only for frames that are not PNG files (JPEG)
and for the scene_points TIFF depth of the lung layout. The geometric flip
is a numpy flip (the same bytes as PIL's FLIP_LEFT_RIGHT).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .augment import AugmentParams, apply_augment
from .png import pil_image, read_image, read_png
from .resample import resize_lanczos, resize_nearest_pil
from .split import parse_split_line


class MonoDataset:
    """Base class: filename list -> frame-triplet items."""

    K_NORM: np.ndarray = None  # subclass: (4, 4) normalized intrinsics
    side_map = {"2": 2, "3": 3, "l": 2, "r": 3}

    def __init__(self, data_path: str, filenames: Sequence[str], height: int,
                 width: int, frame_idxs: Sequence, is_train: bool = False,
                 img_ext: str = ".png", sampling_frequency: int = 1,
                 load_depth: bool = False, seed: int = 0,
                 device_augment: bool = False, native: bool = False):
        self.data_path = data_path
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.frame_idxs = list(frame_idxs)
        self.is_train = is_train
        self.img_ext = img_ext
        self.sampling_frequency = sampling_frequency
        self.load_depth = load_depth and self.check_depth()
        self.seed = seed
        self.frame_cache = None  # set by data.cache.attach_frame_cache
        # ship the 6 drawn jitter factors instead of color_aug; the
        # training step applies them on the device
        self.device_augment = device_augment
        # decode and resize through the native host routines
        # (ops.kernels._lib.native_route), else numpy: the same bytes
        self.native = native

    # -- subclass hooks ------------------------------------------------
    def get_image_path(self, folder: str, frame_index: int,
                       side: Optional[str]) -> str:
        raise NotImplementedError

    def check_depth(self) -> bool:
        return False

    def get_depth(self, folder, frame_index, side, do_flip):
        raise NotImplementedError

    def load_frame(self, folder: str, frame_index: int,
                   side: Optional[str]) -> np.ndarray:
        """The decoded (H0, W0, 3) uint8 RGB frame at its file's
        resolution."""
        return read_image(self.get_image_path(folder, frame_index, side),
                          self.native)

    def load_resized(self, folder: str, frame_index: int,
                     side: Optional[str]) -> np.ndarray:
        """(H, W, 3) uint8 frame at the feed resolution: from the frame
        cache when one is attached and holds it, else decoded and resized
        (PIL's LANCZOS, ``resize_lanczos``)."""
        if self.frame_cache is not None:
            arr = self.frame_cache.get(folder, frame_index, side)
            if arr is not None:
                return arr
        return resize_lanczos(self.load_frame(folder, frame_index, side),
                              self.height, self.width, self.native)

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self.filenames)

    def _rng(self, index: int, epoch: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + epoch) * 4_000_037 + index)

    def get_item(self, index: int, epoch: int = 0):
        rng = self._rng(index, epoch)
        do_flip = self.is_train and rng.random() > 0.5
        aug = AugmentParams.draw(rng, self.is_train)

        folder, frame_index, side = parse_split_line(self.filenames[index])

        colors, colors_aug = [], []
        for i in self.frame_idxs:
            if i == "s":
                other_side = {"r": "l", "l": "r"}[side]
                frame = self.load_resized(folder, frame_index, other_side)
            else:
                frame = self.load_resized(
                    folder, frame_index + i * self.sampling_frequency, side)
            if do_flip:
                frame = np.ascontiguousarray(frame[:, ::-1])
            colors.append(frame)
            if not self.device_augment:
                colors_aug.append(apply_augment(frame, aug))

        item = {
            "color": np.stack(colors, 0),
            "K_norm": self.K_NORM.copy(),
        }
        if self.device_augment:
            item["aug_params"] = aug.to_vector()
        else:
            item["color_aug"] = np.stack(colors_aug, 0)

        if "s" in self.frame_idxs:
            # signed nominal 0.1 baseline
            stereo_T = np.eye(4, dtype=np.float32)
            baseline_sign = -1 if do_flip else 1
            side_sign = -1 if side == "l" else 1
            stereo_T[0, 3] = side_sign * baseline_sign * 0.1
            item["stereo_T"] = stereo_T

        if self.load_depth:
            depth = self.get_depth(folder, frame_index, side, do_flip)
            item["depth_gt"] = depth.astype(np.float32)

        return item


def _read_scene_points_tiff(path: str) -> np.ndarray:
    """SCARED-style scene_points TIFF -> depth plane (channel 0, top 1024
    rows)."""
    Image = pil_image("reading a scene_points TIFF")
    arr = np.asarray(Image.open(path), np.float32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr[:1024, :]


class LungRAWDataset(MonoDataset):
    """Colonoscopy/phantom frames ``<data_path>/<folder>/<10-digit>.png``."""

    K_NORM = np.array([[0.635, 0, 0.48, 0],
                       [0, 0.634, 0.50, 0],
                       [0, 0, 1, 0],
                       [0, 0, 0, 1]], dtype=np.float32)

    def get_image_path(self, folder, frame_index, side):
        return os.path.join(self.data_path, folder,
                            f"{frame_index:010d}{self.img_ext}")

    def _depth_path(self, folder, frame_index, side):
        f_str = f"scene_points{frame_index - 1:06d}.tiff"
        return os.path.join(self.data_path, folder,
                            f"image_0{self.side_map[side]}/data/groundtruth",
                            f_str)

    def check_depth(self):
        folder, frame_index, side = parse_split_line(self.filenames[0])
        return side is not None and os.path.isfile(
            self._depth_path(folder, frame_index, side))

    def get_depth(self, folder, frame_index, side, do_flip):
        depth = _read_scene_points_tiff(
            self._depth_path(folder, frame_index, side))
        if do_flip:
            depth = np.fliplr(depth)
        return depth


class SCAREDRAWDataset(LungRAWDataset):
    """SCARED endoscope stereo: KITTI-style ``image_0{2,3}/data`` paths;
    frames lose 64 rows at the bottom before the resize."""

    K_NORM = np.array([[0.82, 0, 0.5, 0],
                       [0, 1.02, 0.5, 0],
                       [0, 0, 1, 0],
                       [0, 0, 0, 1]], dtype=np.float32)

    def get_image_path(self, folder, frame_index, side):
        f_str = f"{frame_index:010d}{self.img_ext}"
        return os.path.join(self.data_path, folder,
                            f"image_0{self.side_map[side]}/data", f_str)

    def load_frame(self, folder, frame_index, side):
        img = super().load_frame(folder, frame_index, side)
        return img[:img.shape[0] - 64]


class KITTIRAWDataset(MonoDataset):
    """KITTI raw."""

    K_NORM = np.array([[0.58, 0, 0.5, 0],
                       [0, 1.92, 0.5, 0],
                       [0, 0, 1, 0],
                       [0, 0, 0, 1]], dtype=np.float32)
    FULL_RES = (1242, 375)

    def get_image_path(self, folder, frame_index, side):
        f_str = f"{frame_index:010d}{self.img_ext}"
        return os.path.join(self.data_path, folder,
                            f"image_0{self.side_map[side]}/data", f_str)

    def check_depth(self):
        line = parse_split_line(self.filenames[0])
        velo = os.path.join(
            self.data_path, line[0],
            f"velodyne_points/data/{line[1]:010d}.bin")
        return os.path.isfile(velo)

    def get_depth(self, folder, frame_index, side, do_flip):
        from ..eval.kitti_depth import generate_depth_map
        from .resample import resize_nearest_np

        calib = os.path.join(self.data_path, folder.split("/")[0])
        velo = os.path.join(self.data_path, folder,
                            f"velodyne_points/data/{frame_index:010d}.bin")
        depth = generate_depth_map(calib, velo, self.side_map[side])
        depth = resize_nearest_np(depth, self.FULL_RES[1], self.FULL_RES[0])
        if do_flip:
            depth = np.fliplr(depth)
        return depth


class KITTIOdomDataset(KITTIRAWDataset):
    """KITTI odometry."""

    def get_image_path(self, folder, frame_index, side):
        f_str = f"{frame_index:06d}{self.img_ext}"
        return os.path.join(self.data_path,
                            f"sequences/{int(folder):02d}",
                            f"image_{self.side_map[side]}", f_str)

    def check_depth(self):
        return False


class KITTIDepthDataset(KITTIRAWDataset):
    """KITTI with the annotated depth maps (png / 256)."""

    def check_depth(self):
        folder, frame_index, side = parse_split_line(self.filenames[0])
        return os.path.isfile(self._depth_path(folder, frame_index, side))

    def _depth_path(self, folder, frame_index, side):
        return os.path.join(
            self.data_path, folder, "proj_depth/groundtruth",
            f"image_0{self.side_map[side]}", f"{frame_index:010d}.png")

    def get_depth(self, folder, frame_index, side, do_flip):
        depth_png = read_png(self._depth_path(folder, frame_index, side),
                             self.native)
        if depth_png.dtype != np.uint16 or depth_png.ndim != 2:
            raise ValueError(f"annotated depth {depth_png.shape} "
                             f"{depth_png.dtype}: expected 16-bit grey")
        depth_png = resize_nearest_pil(depth_png, self.FULL_RES[1],
                                       self.FULL_RES[0])
        depth = depth_png.astype(np.float32) / 256.0
        if do_flip:
            depth = np.fliplr(depth)
        return depth


class SyntheticDataset:
    """Procedural translating-texture sequences (no disk IO).

    A per-sequence random smooth texture is viewed through a window that
    slides with frame index — a camera translating parallel to a fronto-
    parallel plane. Used by loss-descends tests and benchmarks.
    """

    K_NORM = LungRAWDataset.K_NORM

    def __init__(self, num_items: int, height: int, width: int,
                 frame_idxs: Sequence, is_train: bool = True,
                 sampling_frequency: int = 1, seed: int = 0, shift: int = 2,
                 **_):
        self.num_items = num_items
        self.height = height
        self.width = width
        self.frame_idxs = [f for f in frame_idxs if f != "s"]
        self.is_train = is_train
        self.sampling_frequency = sampling_frequency
        self.seed = seed
        self.shift = shift
        self.load_depth = False

    def __len__(self):
        return self.num_items

    def _texture(self, rng: np.random.Generator, h: int, w: int):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.zeros((h, w, 3), np.float32)
        for _ in range(6):
            fx, fy = rng.uniform(0.01, 0.15, 2)
            phase = rng.uniform(0, 2 * np.pi, 3)
            amp = rng.uniform(0.1, 0.3, 3)
            for ch in range(3):
                img[..., ch] += amp[ch] * np.sin(
                    2 * np.pi * (fx * xx + fy * yy) + phase[ch])
        img -= img.min()
        img /= max(img.max(), 1e-6)
        return img

    def get_item(self, index: int, epoch: int = 0):
        rng = np.random.default_rng(self.seed * 77_003 + index)
        margin = self.shift * self.sampling_frequency * \
            (max(abs(int(f)) for f in self.frame_idxs) + 1)
        tex = self._texture(rng, self.height, self.width + 2 * margin)
        colors = []
        for i in self.frame_idxs:
            off = margin + int(i) * self.shift * self.sampling_frequency
            colors.append(tex[:, off:off + self.width])
        color = np.stack(colors, 0)
        color = (color * 255.0 + 0.5).astype(np.uint8)  # same uint8
        # contract as the disk-backed datasets
        return {"color": color, "color_aug": color.copy(),
                "K_norm": self.K_NORM.copy()}


class SyntheticParallaxDataset:
    """Layered fronto-parallel scenes with EXACT per-pixel GT depth.

    Unlike :class:`SyntheticDataset` (single plane — constant depth, which
    median-scaled eval metrics trivially reward), every item here is a
    procedural scene of a background plane plus nearer elliptical layers at
    distinct depths, viewed by a camera translating along x. Layers shift
    with the correct per-depth parallax (texture and masks are continuous
    functions of the plane coordinates, so sub-pixel shifts are exact and
    photometric consistency holds away from occlusion edges — asserted by
    the reference package's tests). Monodepth training must recover the layered
    structure to win; the exact depth map enables a quantitative
    abs_rel...a3 quality row with zero external data (the eval protocol of
    the original repository's `evaluate_depth.py:181-224`, median scaling, mask
    gt>0).
    """

    K_NORM = LungRAWDataset.K_NORM

    def __init__(self, num_items: int, height: int, width: int,
                 frame_idxs: Sequence, is_train: bool = True,
                 sampling_frequency: int = 1, seed: int = 0,
                 load_depth: bool = False, num_layers: int = 3,
                 cache_items: bool = False, with_rotation: bool = False,
                 **_):
        self.num_items = num_items
        self.height = height
        self.width = width
        self.frame_idxs = [f for f in frame_idxs if f != "s"]
        self.is_train = is_train
        self.sampling_frequency = sampling_frequency
        self.seed = seed
        self.load_depth = load_depth
        self.num_layers = num_layers
        # with_rotation: the camera path additionally yaws by a per-scene
        # constant rate (exact pinhole render of the rotated rays), so pose
        # GT has NONZERO rotations — the odometry benchmark's RE metric
        # measures something (with a pure-translation path
        # RE only ever scored the identity). Default off: the depth quality
        # rows and photometric-consistency tests use the translation-only
        # path.
        self.with_rotation = with_rotation
        # get_item is deterministic per index (epoch is ignored), so items
        # may be memoized: the procedural render costs ~0.2 s/item at
        # 192x640 on a 1-core host, while the pool fits trivially in RAM
        # (uint8 frames). Opt-in; thread-pool loaders share the dict (GIL),
        # process workers each keep their own copy.
        self._cache = {} if cache_items else None

    def __len__(self):
        return self.num_items

    # -- scene ----------------------------------------------------------
    def _scene(self, index: int) -> dict:
        rng = np.random.default_rng(self.seed * 91_003 + index)
        n_blobs = self.num_layers - 1
        depths = np.sort(rng.uniform(3.0, 10.0, n_blobs))[::-1]  # far->near
        blobs = []
        for d in depths:
            blobs.append({
                "depth": float(d),
                "center": (rng.uniform(-0.55, 0.55), rng.uniform(-0.5, 0.5)),
                "radii": (rng.uniform(0.18, 0.38), rng.uniform(0.15, 0.35)),
                "tex": self._tex_params(rng),
            })
        return {
            "d_bg": float(rng.uniform(12.0, 20.0)),
            "bg_tex": self._tex_params(rng),
            "t_x": float(rng.choice([-1.0, 1.0]) * rng.uniform(0.04, 0.09)),
            # constant per-frame yaw rate (radians); used only when
            # with_rotation. ~0.3-0.9 deg/frame keeps every rotated ray
            # forward-facing (rz > 0) across the 192-640 px feeds
            "yaw_rate": float(rng.choice([-1.0, 1.0])
                              * rng.uniform(0.005, 0.015)),
            "blobs": blobs,
        }

    @staticmethod
    def _tex_params(rng) -> list:
        return [(rng.uniform(1.5, 9.0), rng.uniform(1.5, 9.0),
                 rng.uniform(0, 2 * np.pi, 3), rng.uniform(0.1, 0.35, 3))
                for _ in range(5)]

    @staticmethod
    def _tex(params, a, b):
        img = np.zeros(a.shape + (3,), np.float32)
        for fa, fb, phase, amp in params:
            arg = 2 * np.pi * (fa * a + fb * b)
            for ch in range(3):
                img[..., ch] += amp[ch] * np.sin(arg + phase[ch])
        lo, hi = img.min(), img.max()
        return (img - lo) / max(hi - lo, 1e-6)

    def gt_pose(self, index: int, i) -> np.ndarray:
        """4x4 transform cam_0 -> cam_i (a point's coordinates change by
        -camera translation, plus the inverse yaw when with_rotation)."""
        scene = self._scene(index)
        step = float(i) * self.sampling_frequency
        if not self.with_rotation:
            T = np.eye(4, dtype=np.float32)
            T[0, 3] = -step * scene["t_x"]
            return T
        return self._world2cam(scene, step)

    def _world2cam(self, scene: dict, step: float) -> np.ndarray:
        """Extrinsic of the camera ``step`` frame-units along the path:
        position (step * t_x, 0, 0), orientation R_y(step * yaw_rate)."""
        th = step * scene["yaw_rate"] if self.with_rotation else 0.0
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        C = np.array([step * scene["t_x"], 0.0, 0.0], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ C
        return T

    def gt_local_sequence(self, index: int, n_frames: int) -> np.ndarray:
        """(n_frames-1, 4, 4) EXACT local pose per consecutive frame pair
        of render_sequence, in the convention the eval chains
        (the original repository's `evaluate_pose.py:201-213`): L_i maps camera-i
        coordinates to camera-(i+1) coordinates, L_i = E_{i+1} @ inv(E_i).
        With a yawing path the locals are NOT constant in camera frame
        (the translation direction rotates), unlike the tiled gt_pose(1)
        of the translation-only benchmark."""
        scene = self._scene(index)
        Es = [self._world2cam(scene, float(i) * self.sampling_frequency)
              for i in range(n_frames)]
        return np.stack([Es[i + 1] @ np.linalg.inv(Es[i])
                         for i in range(n_frames - 1)], 0)

    def _render(self, scene: dict, cam_x: float, want_depth: bool,
                yaw: float = 0.0):
        h, w = self.height, self.width
        fx, fy = self.K_NORM[0, 0] * w, self.K_NORM[1, 1] * h
        cx, cy = self.K_NORM[0, 2] * w, self.K_NORM[1, 2] * h
        uu, vv = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32))
        xn = (uu - cx) / fx
        yn = (vv - cy) / fy
        if yaw != 0.0:
            # exact pinhole render with the camera yawed about +y: ray
            # (xn, yn, 1) in camera coords -> R_y(yaw) @ ray in world
            # coords; intersect with the fronto-parallel plane z = d at
            # world x/z = xdir, y/z = ray_y
            c, s = float(np.cos(yaw)), float(np.sin(yaw))
            rz = c - s * xn
            assert float(rz.min()) > 0.05, "yaw too large for the FOV"
            xdir = (c * xn + s) / rz
            ray_y = yn / rz
        else:
            xdir = xn
            ray_y = yn
        # plane coords at depth d: a = xdir + cam_x/d (world x / depth)
        a_bg = xdir + cam_x / scene["d_bg"]
        img = self._tex(scene["bg_tex"], a_bg, ray_y)
        depth = None
        if want_depth:
            # per-pixel CAMERA-FRAME depth z = d / (ray z-component);
            # identical to the plane depth when yaw == 0
            depth = np.full((h, w), scene["d_bg"], np.float32)
            if yaw != 0.0:
                depth = scene["d_bg"] / rz
        for blob in scene["blobs"]:  # far -> near: nearer overwrite
            a = xdir + cam_x / blob["depth"]
            ca, cb = blob["center"]
            ra, rb = blob["radii"]
            m = ((a - ca) / ra) ** 2 + ((ray_y - cb) / rb) ** 2 < 1.0
            tex = self._tex(blob["tex"], a, ray_y)
            img = np.where(m[..., None], tex, img)
            if want_depth:
                d_here = (blob["depth"] / rz if yaw != 0.0
                          else np.float32(blob["depth"]))
                depth = np.where(m, d_here, depth)
        return img, depth

    def render_sequence(self, index: int, n_frames: int) -> np.ndarray:
        """(N, H, W, 3) uint8 frames of scene ``index`` with the camera
        translating along x by ``sampling_frequency * t_x`` per frame (the
        same linear path get_item samples at {-1, 0, 1}), for odometry-style
        pose evaluation: the exact local pose between consecutive frames is
        ``gt_pose(index, 1)`` (the original repository's `evaluate_pose.py:201-213`
        consumes local source->target transforms)."""
        scene = self._scene(index)
        frames = []
        for i in range(n_frames):
            step = float(i) * self.sampling_frequency
            yaw = step * scene["yaw_rate"] if self.with_rotation else 0.0
            img, _ = self._render(scene, step * scene["t_x"],
                                  want_depth=False, yaw=yaw)
            frames.append((img * 255.0 + 0.5).astype(np.uint8))
        return np.stack(frames, 0)

    def get_item(self, index: int, epoch: int = 0):
        if self._cache is not None and index in self._cache:
            cached = self._cache[index]
            return {k: v.copy() for k, v in cached.items()}
        scene = self._scene(index)
        colors = []
        depth0 = None
        for i in self.frame_idxs:
            step = float(i) * self.sampling_frequency
            yaw = step * scene["yaw_rate"] if self.with_rotation else 0.0
            img, dep = self._render(scene, step * scene["t_x"],
                                    want_depth=(self.load_depth and i == 0),
                                    yaw=yaw)
            if dep is not None:
                depth0 = dep
            colors.append((img * 255.0 + 0.5).astype(np.uint8))
        color = np.stack(colors, 0)
        item = {"color": color, "color_aug": color.copy(),
                "K_norm": self.K_NORM.copy()}
        if depth0 is not None:
            item["depth_gt"] = depth0
        if self._cache is not None:
            self._cache[index] = {k: v.copy() for k, v in item.items()}
        return item


DATASETS = {
    "endovis": LungRAWDataset,
    "scared": SCAREDRAWDataset,
    "kitti": KITTIRAWDataset,
    "kitti_odom": KITTIOdomDataset,
    "kitti_depth": KITTIDepthDataset,
    "synthetic": SyntheticDataset,
    "synthetic_parallax": SyntheticParallaxDataset,
}


def make_dataset(name: str, **kwargs):
    if name not in DATASETS:
        raise ValueError(f"unknown dataset '{name}' "
                         f"(have {sorted(DATASETS)})")
    return DATASETS[name](**kwargs)
