"""The PyTorch port stands alone: none of its modules, and not
chip_smoke.py, imports JAX, its libraries, PIL, matplotlib or the JAX
package; and chip_smoke.py on a machine without a CUDA device fails fast
without printing a result."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import unsupervised_pose_estimation_tpu_torch as port

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "matplotlib",
           "unsupervised_pose_estimation_tpu")


def port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        names.append(info.name)
    return names


def test_port_imports_nothing_of_jax():
    modules = port_modules()
    assert len(modules) >= 20
    code = "\n".join(
        ["import sys"]
        + [f"sys.modules[{name!r}] = None" for name in BLOCKED]
        + [f"import {name}" for name in modules]
        + ["import chip_smoke",
           "leaked = [m for m in sys.modules if m.split('.')[0] in "
           f"{BLOCKED!r} and sys.modules[m] is not None]",
           "assert not leaked, leaked",
           "print('ok', len(sys.modules))"])
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_fails_fast_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_training_modules_are_among_those_checked():
    """The training slice's modules are imported, JAX-free, above."""
    modules = set(port_modules())
    for name in ("ops.augment_device", "train.state", "train.step",
                 "ops.kernels.warp_loss", "ops.kernels.reproj_loss",
                 "ops.kernels.warp", "models.layers",
                 # files and serving without PIL
                 "data.png", "data.resample", "data.jpeg", "data.colormap",
                 "data.make_splits", "data.cache", "data.datasets",
                 "cli.build_frame_cache", "cli.serve", "cli.export_model",
                 "cli.test_simple", "cli.export_gt_depth", "serve",
                 "utils"):
        assert f"{port.__name__}.{name}" in modules, name
    sources = {p.name for p in (ROOT / port.__name__ / "csrc").glob("*.cu")}
    assert {"warp_loss_bwd.cu", "reproj_loss_bwd.cu"} <= sources
    assert (ROOT / port.__name__ / "csrc" / "image_host.cpp").is_file()


def test_ladder_modules_are_among_those_checked():
    """The warp ladder's modules and kernel source are imported, JAX-free,
    above, and built with the others."""
    modules = set(port_modules())
    for name in ("ops.kernels.corners", "ops.kernels.warp", "train.step",
                 "profile_step"):
        assert f"{port.__name__}.{name}" in modules, name
    sources = {p.name for p in (ROOT / port.__name__ / "csrc").glob("*.cu")}
    assert "corners.cu" in sources


def test_trainer_modules_are_among_those_checked():
    """The training entry point's modules are imported, JAX-free and
    PIL-free, above; PIL stays blocked there."""
    modules = set(port_modules())
    for name in ("data.datasets", "data.pipeline", "data.cache",
                 "data.augment", "data.split", "train.loop",
                 "train.checkpoint", "train.logging", "eval.metrics",
                 "cli.train"):
        assert f"{port.__name__}.{name}" in modules, name
    assert "PIL" in BLOCKED


def test_evaluation_modules_are_among_those_checked():
    """The evaluation drivers and their entry points are imported, JAX-,
    PIL- and matplotlib-free, above (both import them only on the routes
    that need them)."""
    modules = set(port_modules())
    for name in ("eval.evaluate_depth", "eval.evaluate_pose",
                 "cli.evaluate_depth", "cli.evaluate_pose"):
        assert f"{port.__name__}.{name}" in modules, name
    assert {"PIL", "matplotlib"} <= set(BLOCKED)


def test_option_modules_are_among_those_checked():
    """The modules of the training options (PoseCNN, the upstream decoder's
    nearest upsample, the option-aware bundle and step) are imported,
    JAX-free, above."""
    modules = set(port_modules())
    for name in ("models.pose_cnn", "models.depth_decoder", "ops.resize",
                 "train.bundle", "train.step", "convert", "serve"):
        assert f"{port.__name__}.{name}" in modules, name


def test_mesh_modules_are_among_those_checked():
    """The mesh, its dry run and the modules that take a process group are
    imported, JAX-free, above."""
    modules = set(port_modules())
    for name in ("parallel", "parallel.mesh", "parallel.dryrun",
                 "data.pipeline", "models.layers", "train.state",
                 "train.checkpoint", "train.loop", "cli.train"):
        assert f"{port.__name__}.{name}" in modules, name


def test_last_host_routes_run_without_pil_or_matplotlib(tmp_path):
    """With PIL and matplotlib unimportable, in a fresh process: a
    scene_points TIFF read (LZW and deflate), a JPEG decode and encode
    (decode_image included), the host jitter, plot_trajectory (vo.png
    read back) and rare-PNG decodes (Adam7, 1-bit, 16-bit RGBA)."""
    code = f"""
import sys
for name in ("PIL", "matplotlib"):
    sys.modules[name] = None
from pathlib import Path
import numpy as np
from unsupervised_pose_estimation_tpu_torch.data import augment, jpeg, png
from unsupervised_pose_estimation_tpu_torch.data.tiff import read_scene_points
from unsupervised_pose_estimation_tpu_torch.eval.evaluate_pose import \\
    plot_trajectory
fixtures = Path({str(ROOT / "tests" / "data" / "pil")!r})
for name in ("f32_tiff_lzw.tiff", "f32_tiff_deflate.tiff"):
    assert read_scene_points(str(fixtures / name)).dtype == np.float32
for name in ("prog_420.jpg", "grey_base.jpg", "base_411.jpg"):
    data = (fixtures / name).read_bytes()
    assert png.decode_image(data).shape == (35, 51, 3)
rgb = np.random.default_rng(0).integers(0, 256, (20, 30, 3), np.uint8)
assert jpeg.decode_jpeg(jpeg.encode_jpeg(rgb)).shape == (20, 30, 3)
out = augment.apply_augment(rgb, augment.AugmentParams(
    True, 1.1, 0.9, 1.2, 0.05, True))
assert out.shape == rgb.shape and out.dtype == np.uint8
walk = np.cumsum(np.ones((6, 3)), 0)
plot_trajectory(walk, walk * 2, {str(tmp_path / "vo.png")!r})
assert png.read_png({str(tmp_path / "vo.png")!r}).shape == (720, 960, 3)
for name in ("c0_d1.png", "c6_d16_adam7.png", "c3_d2_adam7.png"):
    assert png.to_rgb(png.read_png(str(fixtures / name))).shape == \\
        (13, 21, 3)
leaked = [m for m in sys.modules if m.split(".")[0] in ("PIL", "matplotlib")
          and sys.modules[m] is not None]
assert not leaked, leaked
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
