"""The port's file routes against the JAX package's, bit for bit: items of
the lung, SCARED and KITTI-depth datasets decoded from PNG trees (the port
with ``data.png`` and ``data.resample``, the JAX package with PIL), the
frame cache ``cli.build_frame_cache`` writes, the split files of
``data.make_splits``, the ``gt_depths.npz`` of ``cli.export_gt_depth``,
the PNGs of ``--log_images`` and ``--eval_split benchmark``, and ``utils``
(as ``tests/test_utils.py`` checks the JAX one, with the download faked)."""

import hashlib
import io
import os
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from unsupervised_pose_estimation_tpu import utils as jutils
from unsupervised_pose_estimation_tpu.cli import \
    build_frame_cache as jbuild_cache
from unsupervised_pose_estimation_tpu.cli import \
    export_gt_depth as jexport_gt
from unsupervised_pose_estimation_tpu.data import datasets as jdatasets
from unsupervised_pose_estimation_tpu.data import make_splits as jsplits
from unsupervised_pose_estimation_tpu.eval import evaluate_depth as jeval
from unsupervised_pose_estimation_tpu_torch import utils
from unsupervised_pose_estimation_tpu_torch.cli import \
    build_frame_cache as build_cache
from unsupervised_pose_estimation_tpu_torch.cli import export_gt_depth
from unsupervised_pose_estimation_tpu_torch.data import datasets, make_splits
from unsupervised_pose_estimation_tpu_torch.data.png import read_png
from unsupervised_pose_estimation_tpu_torch.eval import evaluate_depth
from unsupervised_pose_estimation_tpu_torch.train.logging import (
    MetricLogger, normalize_image)

H, W = 32, 64
KITTI_FOLDER = "2011_09_26/2011_09_26_drive_0002_sync"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def frame(rng, h, w, mode):
    """A smooth frame with noise, as a PIL image of ``mode``."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 9.0 + rng.uniform(0, 6)) + np.cos(yy / 7.0)) * 50
    pix = np.clip(base[..., None] + 128 + rng.normal(0, 8, (h, w, 4)), 0,
                  255).astype(np.uint8)
    if mode == "L":
        return Image.fromarray(pix[..., 0], "L")
    if mode == "P":
        return Image.fromarray(pix[..., :3]).quantize(64)
    return Image.fromarray(pix[..., :len(mode)], mode)


def write_frames(folder, rng, h, w, n, first=0):
    """``n`` PNG frames <10-digit>.png, cycling through the colour types
    the decoder reads."""
    os.makedirs(folder, exist_ok=True)
    modes = ("RGB", "L", "RGBA", "P", "LA")
    for i in range(first, first + n):
        frame(rng, h, w, modes[i % len(modes)]).save(
            os.path.join(folder, f"{i:010d}.png"), optimize=bool(i % 2))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A lung tree (two sequences), a SCARED tree and a KITTI tree with
    annotated depth, their split lines, and the splits directory."""
    root = str(tmp_path_factory.mktemp("trees"))
    rng = np.random.default_rng(0)
    lung = os.path.join(root, "lung")
    for seq in ("seq1", "seq2"):
        write_frames(os.path.join(lung, seq), rng, 72, 96, 12)
    scared = os.path.join(root, "scared")
    for side in ("02", "03"):
        write_frames(os.path.join(scared, "d1", f"image_{side}", "data"),
                     rng, 128, 160, 6)
    kitti = os.path.join(root, "kitti")
    write_frames(os.path.join(kitti, KITTI_FOLDER, "image_02", "data"), rng,
                 94, 310, 6)
    gt = os.path.join(kitti, KITTI_FOLDER, "proj_depth", "groundtruth",
                      "image_02")
    os.makedirs(gt)
    for i, (h, w) in enumerate([(370, 1224), (375, 1242), (376, 1241)] * 2):
        depth = rng.integers(0, 20000, (h, w)).astype(np.uint16)
        depth[rng.random((h, w)) < 0.7] = 0  # sparse, as the real maps
        Image.fromarray(depth).save(os.path.join(gt, f"{i:010d}.png"))
    splits = os.path.join(root, "splits")
    make_splits.write_split(lung, os.path.join(splits, "lung"), suffix="")
    os.makedirs(os.path.join(splits, "eigen_benchmark"))
    with open(os.path.join(splits, "eigen_benchmark", "test_files.txt"),
              "w") as f:
        f.write("".join(f"{KITTI_FOLDER} {i} l\n" for i in range(3)))
    return dict(root=root, lung=lung, scared=scared, kitti=kitti,
                splits=splits)


CASES = {
    "endovis": ("lung", [f"seq1 {i} l" for i in range(1, 11)], H, W),
    "scared": ("scared", [f"d1 {i} {s}" for i in range(1, 5)
                          for s in "lr"], 64, 96),
    "kitti_depth": ("kitti", [f"{KITTI_FOLDER} {i} l" for i in range(1, 5)],
                    H, W),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_file_items_match_jax(trees, name):
    """Items from the PNG trees (flips, jitter factors, the stereo frame of
    SCARED, the annotated depth of KITTI): the JAX datasets' bytes."""
    tree, lines, h, w = CASES[name]
    frames = [0, -1, 1] + (["s"] if name == "scared" else [])
    kw = dict(data_path=trees[tree], filenames=lines, height=h, width=w,
              frame_idxs=frames, is_train=True, seed=3,
              load_depth=name == "kitti_depth", device_augment=True)
    ours = datasets.make_dataset(name, **kw)
    ref = jdatasets.make_dataset(name, **kw)
    assert ours.load_depth == (name == "kitti_depth")
    for index in range(len(lines)):
        a, b = ours.get_item(index, 1), ref.get_item(index, 1)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_frame_cache_matches_jax(trees, tmp_path):
    """cli.build_frame_cache writes the bytes of the JAX tool's cache, with
    a frame the split reaches missing from the tree."""
    common = ["--dataset", "endovis", "--split", "lung", "--split_dir",
              trees["splits"], "--data_path", trees["lung"], "--height",
              str(H), "--width", str(W)]
    # write_split holds out the first and last frames of each sequence;
    # the trainer's boundary trim keeps one more
    os.rename(os.path.join(trees["lung"], "seq2", f"{5:010d}.png"),
              os.path.join(trees["root"], "moved.png"))
    try:
        jbuild_cache.main(common + ["--frame_cache", str(tmp_path / "j")])
        stats = build_cache.main(
            common + ["--frame_cache", str(tmp_path / "t")], device="cpu")
    finally:
        os.rename(os.path.join(trees["root"], "moved.png"),
                  os.path.join(trees["lung"], "seq2", f"{5:010d}.png"))
    assert stats["train"]["rows"] > 10
    assert stats["train"]["skipped"] + stats["val"]["skipped"] >= 1
    for mode in ("train", "val"):
        for name in ("frames_u8.npy", "index.json"):
            a = (tmp_path / "j" / mode / name).read_bytes()
            b = (tmp_path / "t" / mode / name).read_bytes()
            assert a == b, (mode, name)


def test_write_split_matches_jax(trees, tmp_path):
    for kw in ({}, {"val_fraction": 0.3, "side": "r", "margin": 2,
                    "seed": 5, "suffix": ""}):
        ours = make_splits.write_split(trees["lung"], str(tmp_path / "t"),
                                       **kw)
        ref = jsplits.write_split(trees["lung"], str(tmp_path / "j"), **kw)
        for a, b in zip(ours, ref):
            assert os.path.basename(a) == os.path.basename(b)
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read()
    assert make_splits.scan_sequences(trees["lung"]) == \
        jsplits.scan_sequences(trees["lung"])


def test_export_gt_depth_matches_jax(trees, tmp_path):
    """eigen_benchmark's annotated 16-bit PNGs -> the JAX tool's npz."""
    out = {}
    for tag, tool in (("jax", jexport_gt), ("port", export_gt_depth)):
        argv = ["--data_path", trees["kitti"], "--split", "eigen_benchmark",
                "--split_dir", trees["splits"]]
        if tool is export_gt_depth:
            tool.main(argv, device="cpu")
        else:
            tool.main(argv)
        path = os.path.join(trees["splits"], "eigen_benchmark",
                            "gt_depths.npz")
        out[tag] = np.load(path, allow_pickle=True)["data"]
        os.replace(path, str(tmp_path / f"{tag}.npz"))
    assert out["port"].dtype == out["jax"].dtype == object
    assert len(out["port"]) == len(out["jax"]) == 3
    for a, b in zip(out["port"], out["jax"]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_log_and_benchmark_pngs_read_back(tmp_path):
    """--log_images PNGs decode to the logged images' bytes, and the
    benchmark PNGs to the bytes of the JAX package's (written with PIL)."""
    rng = np.random.default_rng(4)
    logger = MetricLogger(str(tmp_path), "m", jsonl=False)
    images = {"disp/0": rng.random((16, 24)).astype(np.float32),
              "color_pred/-1_0": rng.random((16, 24, 3)).astype(np.float32),
              "automask/0": rng.random((16, 24, 1)).astype(np.float32)}
    logger.log_images("val", images, 7)
    for name, img in images.items():
        arr = np.asarray(normalize_image(img))
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        want = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        path = tmp_path / "m" / "images" / "step_7" / \
            f"val_{name.replace('/', '_')}.png"
        np.testing.assert_array_equal(read_png(str(path)), want)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    # --eval_split benchmark on saved predictions, through both packages
    disps = rng.random((2, 24, 80)).astype(np.float32) * 0.3
    np.save(tmp_path / "disps.npy", disps)
    for tag, ev in (("jax", jeval), ("port", evaluate_depth)):
        os.makedirs(tmp_path / tag)
        opt = ev.Options(eval_split="benchmark", eval_mono=True,
                         ext_disp_to_eval=str(tmp_path / "disps.npy"),
                         load_weights_folder=str(tmp_path / tag))
        assert (ev.evaluate(opt) if ev is jeval
                else ev.evaluate(opt, device="cpu")) is None
    for idx in range(2):
        name = f"{idx:010d}.png"
        ours = read_png(str(tmp_path / "port" / "benchmark_predictions" /
                            name))
        assert ours.dtype == np.uint16 and ours.shape == (352, 1216)
        want = tmp_path / "jax" / "benchmark_predictions" / name
        np.testing.assert_array_equal(ours, np.asarray(Image.open(want)))


@pytest.fixture
def fake_download(monkeypatch):
    """A model zip served by a fake urlretrieve (no network)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("encoder.pth", b"fake-encoder-weights")
        z.writestr("depth.pth", b"fake-depth-weights")
    payload = buf.getvalue()
    calls = []

    def fake_urlretrieve(url, dst):
        calls.append(url)
        with open(dst, "wb") as f:
            f.write(payload)

    monkeypatch.setitem(utils.DOWNLOAD_MODELS, "mono_640x192", (
        "https://example.invalid/mono_640x192.zip",
        hashlib.md5(payload).hexdigest()))
    monkeypatch.setattr(utils.urllib.request, "urlretrieve",
                        fake_urlretrieve)
    return calls


def test_utils_download_verifies_unzips_and_caches(fake_download, tmp_path):
    assert utils.DOWNLOAD_MODELS.keys() == jutils.DOWNLOAD_MODELS.keys()
    models = str(tmp_path / "models")
    utils.download_model_if_doesnt_exist("mono_640x192", models)
    assert len(fake_download) == 1
    assert os.path.isfile(os.path.join(models, "mono_640x192",
                                       "encoder.pth"))
    utils.download_model_if_doesnt_exist("mono_640x192", models)
    assert len(fake_download) == 1  # present: no second download


def test_utils_errors(fake_download, monkeypatch, tmp_path):
    monkeypatch.setitem(utils.DOWNLOAD_MODELS, "mono_640x192", (
        "https://example.invalid/mono_640x192.zip", "0" * 32))
    with pytest.raises(RuntimeError, match="checksum"):
        utils.download_model_if_doesnt_exist("mono_640x192",
                                             str(tmp_path / "a"))

    def refuse(url, dst):
        raise OSError("no route to host")

    monkeypatch.setattr(utils.urllib.request, "urlretrieve", refuse)
    with pytest.raises(RuntimeError, match="offline"):
        utils.download_model_if_doesnt_exist("mono_640x192",
                                             str(tmp_path / "b"))
    with pytest.raises(ValueError, match="unknown model"):
        utils.download_model_if_doesnt_exist("nope", str(tmp_path / "c"))


def test_utils_rescale_and_reexports_match_jax():
    rng = np.random.default_rng(5)
    x = np.stack([np.full((4, 4), 2.0), rng.random((4, 4)) * 9], axis=-1)
    np.testing.assert_array_equal(utils.rescale(x), jutils.rescale(x))
    np.testing.assert_allclose(utils.rescale(x)[..., 1].min(), 0.0)
    np.testing.assert_allclose(utils.rescale(x)[..., 1].max(), 1.0)
    assert utils.sec_to_hm_str(3725) == jutils.sec_to_hm_str(3725)
    img = rng.random((5, 6)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(utils.normalize_image(img)),
                                  np.asarray(jutils.normalize_image(img)))
