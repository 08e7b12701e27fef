"""The port's data layer and options against the JAX package's.

Same seeds and files go through both packages: synthetic items, the
augmentation draws, lung-tree items from PNG files and from a frame cache,
the cache fingerprint, Loader batches (two epochs and a mid-epoch resume),
and the options parser. Every comparison is exact (bit for bit), since the
port keeps the reference's numpy code and draws.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from unsupervised_pose_estimation_tpu import config as jconfig
from unsupervised_pose_estimation_tpu.data import augment as jaugment
from unsupervised_pose_estimation_tpu.data import cache as jcache
from unsupervised_pose_estimation_tpu.data import datasets as jdatasets
from unsupervised_pose_estimation_tpu.data.pipeline import Loader as JLoader
from unsupervised_pose_estimation_tpu_torch import config
from unsupervised_pose_estimation_tpu_torch.data import augment, cache, datasets
from unsupervised_pose_estimation_tpu_torch.data.pipeline import Loader

H, W = 32, 48


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def lung_tree(tmp_path):
    """A lung-style dataset: <data>/<folder>/<10-digit>.png (the fixture of
    tests/test_data.py)."""
    folder = tmp_path / "seq1"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for idx in range(30):
        arr = rng.integers(0, 255, size=(48, 64, 3), dtype=np.uint8)
        Image.fromarray(arr).save(folder / f"{idx:010d}.png")
    lines = [f"seq1 {i} l" for i in range(3, 27)]
    return str(tmp_path), lines


def assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("name,kwargs", [
    ("synthetic", {}),
    ("synthetic_parallax", {}),
    ("synthetic_parallax", {"load_depth": True}),
    ("synthetic_parallax", {"load_depth": True, "with_rotation": True,
                            "sampling_frequency": 2}),
])
def test_synthetic_items_bit_identical(name, kwargs):
    mk = dict(num_items=6, height=H, width=W, frame_idxs=[0, -1, 1],
              seed=3, **kwargs)
    ours = datasets.make_dataset(name, **mk)
    ref = jdatasets.make_dataset(name, **mk)
    for index in (0, 5):
        assert_items_equal(ours.get_item(index, 1), ref.get_item(index, 1))


def test_parallax_geometry_helpers_match():
    mk = dict(num_items=3, height=H, width=W, frame_idxs=[0, -1, 1],
              with_rotation=True)
    ours = datasets.SyntheticParallaxDataset(**mk)
    ref = jdatasets.SyntheticParallaxDataset(**mk)
    np.testing.assert_array_equal(ours.render_sequence(1, 3),
                                  ref.render_sequence(1, 3))
    np.testing.assert_array_equal(ours.gt_pose(2, -1), ref.gt_pose(2, -1))
    np.testing.assert_array_equal(ours.gt_local_sequence(0, 4),
                                  ref.gt_local_sequence(0, 4))


@pytest.mark.parametrize("seed", range(6))
def test_augment_draw_and_vector_match(seed):
    for is_train in (True, False):
        ours = augment.AugmentParams.draw(np.random.default_rng(seed),
                                          is_train)
        ref = jaugment.AugmentParams.draw(np.random.default_rng(seed),
                                          is_train)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        np.testing.assert_array_equal(ours.to_vector(), ref.to_vector())


def lung(pkg, data_path, lines, device_augment, is_train=True):
    return pkg.LungRAWDataset(data_path, lines, height=H, width=W,
                              frame_idxs=[0, -1, 1], is_train=is_train,
                              sampling_frequency=2, seed=4,
                              device_augment=device_augment)


@pytest.mark.parametrize("device_augment", [True, False])
@pytest.mark.parametrize("source", ["disk", "jax_cache", "port_cache"])
def test_lung_items_bit_identical(lung_tree, tmp_path, source,
                                  device_augment):
    """From the PNG files, and from a frame cache built by either package
    (both read by the port): the same items as the JAX package's from
    disk, flips and jitter included."""
    data_path, lines = lung_tree
    ours = lung(datasets, data_path, lines, device_augment)
    ref = lung(jdatasets, data_path, lines, device_augment)
    if source != "disk":
        cache_dir = str(tmp_path / source)
        if source == "jax_cache":
            jcache.build_frame_cache(lung(jdatasets, data_path, lines,
                                          device_augment), cache_dir)
        else:
            cache.build_frame_cache(lung(datasets, data_path, lines,
                                         device_augment), cache_dir)
        cache.attach_frame_cache(ours, cache_dir)
    flips = 0
    for index in range(0, len(lines) - 2, 3):
        for epoch in (0, 1):
            a, b = ours.get_item(index, epoch), ref.get_item(index, epoch)
            assert_items_equal(a, b)
            flips += not np.array_equal(
                a["color"], lung(jdatasets, data_path, lines, True,
                                 is_train=False).get_item(index)["color"])
    assert flips > 0  # the geometric flip was exercised


def test_caches_of_both_packages_are_the_same_bytes(lung_tree, tmp_path):
    data_path, lines = lung_tree
    jcache.build_frame_cache(lung(jdatasets, data_path, lines, True),
                             str(tmp_path / "j"))
    cache.build_frame_cache(lung(datasets, data_path, lines, True),
                            str(tmp_path / "t"))
    for name in (cache.FRAMES_FILE, cache.INDEX_FILE):
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name


def test_cache_route_needs_no_pil(lung_tree, tmp_path, monkeypatch):
    """With PIL unimportable, a cached dataset still yields its items, and
    so does an uncached one: PNG frames are decoded and resized without
    PIL (data.png, data.resample)."""
    data_path, lines = lung_tree
    cache_dir = str(tmp_path / "cache")
    jcache.build_frame_cache(lung(jdatasets, data_path, lines, True),
                             cache_dir)
    want = lung(jdatasets, data_path, lines, True).get_item(2, 1)
    monkeypatch.setitem(sys.modules, "PIL", None)
    ours = lung(datasets, data_path, lines, True)
    cache.attach_frame_cache(ours, cache_dir)
    assert_items_equal(ours.get_item(2, 1), want)
    assert_items_equal(lung(datasets, data_path, lines, True).get_item(2, 1),
                       want)


def test_fingerprint_matches(lung_tree):
    data_path, lines = lung_tree
    for device_augment in (True, False):
        assert cache.dataset_fingerprint(
            lung(datasets, data_path, lines, device_augment)) == \
            jcache.dataset_fingerprint(
                lung(jdatasets, data_path, lines, device_augment))
    mk = dict(data_path=data_path, filenames=lines, height=H, width=W,
              frame_idxs=[0, -1, 1])
    assert cache.dataset_fingerprint(datasets.SCAREDRAWDataset(**mk)) == \
        jcache.dataset_fingerprint(jdatasets.SCAREDRAWDataset(**mk))
    assert cache.enumerate_frames(datasets.LungRAWDataset(**mk)) == \
        jcache.enumerate_frames(jdatasets.LungRAWDataset(**mk))


def parallax(pkg, n=12):
    return pkg.SyntheticParallaxDataset(n, H, W, [0, -1, 1], seed=2,
                                        load_depth=True, cache_items=True)


def jax_batches(loader, epoch, start_batch=0):
    return [{k: np.asarray(v) for k, v in b.items()}
            for b in loader.epoch(epoch, start_batch)]


def port_batches(loader, epoch, start_batch=0):
    return [{k: v.numpy() for k, v in b.items()}
            for b in loader.epoch(epoch, start_batch)]


def test_loader_batches_match_two_epochs_and_resume():
    ours = Loader(parallax(datasets), 4, shuffle=True, device="cpu",
                  num_workers=3, prefetch=2, seed=5)
    ref = JLoader(parallax(jdatasets), 4, shuffle=True, num_workers=3,
                  prefetch=2, seed=5, sharding=None)
    for epoch in (0, 1):
        a, b = port_batches(ours, epoch), jax_batches(ref, epoch)
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert_items_equal(x, y)
    np.testing.assert_array_equal(ours._indices(1), ref._indices(1))
    a, b = port_batches(ours, 1, start_batch=2), jax_batches(ref, 1, 2)
    assert len(a) == 1
    assert_items_equal(a[0], b[0])
    assert ours.batches == 7
    assert ours.wait_seconds >= 0.0


def test_process_workers_give_the_thread_batches():
    threads = Loader(parallax(datasets), 4, device="cpu", num_workers=2,
                     seed=1)
    procs = Loader(parallax(datasets), 4, device="cpu", num_workers=2,
                   num_worker_procs=2, seed=1)
    try:
        for x, y in zip(port_batches(threads, 0), port_batches(procs, 0)):
            assert_items_equal(x, y)
    finally:
        procs.close()


class _Broken:
    def __len__(self):
        return 8

    def get_item(self, index, epoch=0):
        if index == 5:
            raise RuntimeError("bad item 5")
        return {"x": np.full((2,), index, np.float32)}


def test_worker_error_reaches_the_consumer():
    loader = Loader(_Broken(), 4, shuffle=False, device="cpu", num_workers=2)
    with pytest.raises(RuntimeError, match="bad item 5"):
        list(loader.epoch(0))


def test_early_exit_stops_the_producer():
    import threading

    loader = Loader(parallax(datasets, 16), 4, device="cpu", num_workers=2,
                    prefetch=1, infinite=True)
    it = iter(loader)
    next(it)
    it.close()
    assert not any(t.name == "loader-producer" and t.is_alive()
                   for t in threading.enumerate())


ARGV = ["--preset", "kitti_upstream", "--batch_size", "4", "--frame_ids",
        "0", "-2", "2", "--no_ssim", "--eval_pose_trajectory",
        "--steps_per_epoch", "7", "--compute_dtype", "float32",
        "--log_dir", "/nonexistent/logs"]


def test_parse_options_matches():
    ours = config.parse_options(ARGV)
    ref = jconfig.parse_options(ARGV)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.batch_size == 4 and ours.width == 640  # flag over preset
    assert ours.eval_pose_trajectory is False
    assert (ours.num_input_frames, ours.use_pose_net, ours.source_frame_ids
            ) == (ref.num_input_frames, ref.use_pose_net,
                  ref.source_frame_ids)
    stereo = dataclasses.replace(ours, use_stereo=True, frame_ids=(0,))
    jstereo = dataclasses.replace(ref, use_stereo=True, frame_ids=(0,))
    assert (stereo.use_pose_net, stereo.source_frame_ids) == \
        (jstereo.use_pose_net, jstereo.source_frame_ids)
    assert config.parse_options([]) == config.Options()


def test_options_json_loads_in_both_packages():
    ours = config.parse_options(ARGV)
    assert jconfig.Options.from_json(ours.to_json()) == \
        jconfig.parse_options(ARGV)
    ref = jconfig.parse_options(ARGV)
    assert config.Options.from_json(ref.to_json()) == ours
    assert json.loads(ours.to_json()) == json.loads(ref.to_json())


@pytest.mark.parametrize("bad", [dict(height=100), dict(frame_ids=(1, 0)),
                                 dict(predictive_mask=True),
                                 dict(adversarial_prior=True),
                                 dict(batch_size=6, grad_accum=4)])
def test_validate_refuses_what_the_reference_refuses(bad):
    with pytest.raises(AssertionError):
        jconfig.Options(**bad).validate()
    with pytest.raises(ValueError):
        config.Options(**bad).validate()
    assert config.Options().validate() == config.Options()
