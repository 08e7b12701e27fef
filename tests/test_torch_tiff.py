"""The port's scene_points TIFF reader (``data.tiff``) held to the JAX
package's ``_read_scene_points_tiff`` (PIL) on the same files: every layout
it reads, written by Pillow 12.1.0 (libtiff 4.7.1) or by hand (MM, tiles,
predictor 2); its refusals, where the JAX reader raises too for the
3-sample float32 file; the native LZW decoder (built with ``g++`` here)
against numpy; and the lung dataset's ground truth against the JAX
dataset's."""

import io
import os
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.make_pil_fixtures import picture, tiff_bytes
from tests.test_torch_image_io import gcc_library  # noqa: F401
from unsupervised_pose_estimation_tpu.data import datasets as JD
from unsupervised_pose_estimation_tpu_torch.data import datasets, tiff
from unsupervised_pose_estimation_tpu_torch.data.png import write_png
from unsupervised_pose_estimation_tpu_torch.ops.kernels import _lib

FIXTURES = Path(__file__).resolve().parent / "data" / "pil"


def pil_tiff(arr, compression, **kwargs):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "TIFF", compression=compression, **kwargs)
    return buf.getvalue()


def layouts(rng, h, w):
    """Arrays of each sample layout read: float32, uint8, uint16, int32,
    RGB, RGBA."""
    return {"f32": (rng.random((h, w)) * 80).astype(np.float32),
            "u8": rng.integers(0, 256, (h, w), np.uint8),
            "u16": rng.integers(0, 65536, (h, w)).astype(np.uint16),
            "i32": rng.integers(-10 ** 7, 10 ** 7, (h, w)).astype(np.int32),
            "rgb": picture(rng, h, w), "rgba": picture(rng, h, w, 4)}


def same_as_reference(tmp_path, data, name="x.tiff"):
    """read_scene_points and the JAX reader on one file: bit-equal; and
    decode_tiff against np.asarray(Image.open(f)); -> the plane."""
    path = tmp_path / name
    path.write_bytes(data)
    got = tiff.read_scene_points(str(path))
    want = JD._read_scene_points_tiff(str(path))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    with Image.open(io.BytesIO(data)) as img:
        ref = np.asarray(img)
    full = tiff.decode_tiff(data)
    np.testing.assert_array_equal(full, ref.astype(ref.dtype.newbyteorder(
        "=")))
    return got


def test_pil_written_layouts_match_reference(tmp_path):
    """Each sample layout under each compression (none, deflate, LZW,
    PackBits), predictor 2 on the integer ones, one strip and many
    (1100 rows: the top 1024 kept)."""
    rng = np.random.default_rng(0)
    n = 0
    for (h, w) in ((1, 1), (13, 21)):
        for name, arr in layouts(rng, h, w).items():
            for comp in ("raw", "tiff_deflate", "tiff_lzw", "packbits"):
                extra = ({} if name == "f32" else {"tiffinfo": {317: 2}}) \
                    if comp == "tiff_lzw" else {}
                same_as_reference(tmp_path, pil_tiff(arr, comp, **extra))
                n += 1
    tall = (rng.random((1100, 9)) * 40).astype(np.float32)
    for comp in ("raw", "tiff_lzw"):
        plane = same_as_reference(tmp_path, pil_tiff(tall, comp))
        assert plane.shape == (1024, 9)
    assert n == 48


def test_hand_made_layouts_match_reference(tmp_path):
    """Big-endian files, tiles that hang past the image, predictor 2 on
    each integer width, PackBits written by hand; compressed big-endian
    32-bit samples come back byte-swapped, as PIL reads them."""
    rng = np.random.default_rng(1)
    arrays = layouts(rng, 37, 45)
    for order in ("<", ">"):
        for name, arr in arrays.items():
            for tile in (None, (16, 16)):
                for comp in (1, 8, 32773):
                    pred = 2 if name not in ("f32",) and comp == 8 else 1
                    data = tiff_bytes(arr, order, tile, comp, pred)
                    same_as_reference(tmp_path, data)
    swapped = tiff.decode_tiff(tiff_bytes(arrays["f32"], ">", None, 8))
    np.testing.assert_array_equal(swapped.view(np.uint32),
                                  arrays["f32"].byteswap().view(np.uint32))


def test_fixtures_match_pil():
    files = sorted(FIXTURES.glob("*.tiff"))
    assert len(files) == 16
    for path in files:
        data = path.read_bytes()
        with Image.open(path) as img:
            ref = np.asarray(img)
        np.testing.assert_array_equal(
            tiff.decode_tiff(data), ref.astype(ref.dtype.newbyteorder("=")),
            err_msg=path.name)


def test_refuses_what_it_does_not_read(tmp_path):
    """The 3-sample float32 file (which PIL cannot open either), float64,
    separate planes, a palette, JPEG compression, predictor 3, BigTIFF, a
    truncated strip: each a ValueError that names it."""
    rng = np.random.default_rng(2)
    xyz = (rng.random((8, 5, 3)) * 10).astype(np.float32)
    data = tiff_bytes(xyz, photometric=2)
    path = tmp_path / "xyz.tiff"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="3 sample.* of 32 bits, sample "
                       "format 3"):
        tiff.read_scene_points(str(path))
    with pytest.raises(Exception):
        JD._read_scene_points_tiff(str(path))
    plane = (rng.random((8, 5)) * 10).astype(np.float32)
    u8 = rng.integers(0, 256, (8, 5, 3), np.uint8)
    cases = [
        (tiff_bytes(plane.astype(np.float64)), "1 sample.* of 64 bits"),
        (tiff_bytes(plane, photometric=0), "photometric interpretation 0"),
        (tiff_bytes(u8[..., 0], photometric=3),
         "photometric interpretation 3"),
        (tiff_bytes(u8).replace(struct.pack("<HHIHxx", 259, 3, 1, 1),
                                struct.pack("<HHIHxx", 259, 3, 1, 7)),
         "compression 7"),
        (tiff_bytes(plane, "<", None, 8, 3), "predictor 3"),
        (tiff_bytes(u8, extra_tags=[(284, 3, [2])]), "separate sample "
         "planes"),
        (b"II+\x00" + bytes(12), "BigTIFF"),
        (tiff_bytes(plane).replace(struct.pack("<HHII", 279, 4, 1, 160),
                                   struct.pack("<HHII", 279, 4, 1, 10 ** 6)),
         "truncated TIFF strip 0"),
    ]
    for data, match in cases:
        with pytest.raises(ValueError, match=match):
            tiff.decode_tiff(data)


def test_native_lzw_matches_numpy(gcc_library):
    """The native LZW decoder gives numpy's bytes on Pillow's LZW files (a
    table that fills and clears) and refuses a code not yet defined."""
    rng = np.random.default_rng(3)
    files = [pil_tiff(arr, "tiff_lzw") for arr in layouts(rng, 13, 21)
             .values()]
    files.append(pil_tiff((rng.random((300, 200)) * 50).astype(np.float32),
                          "tiff_lzw"))
    files += [p.read_bytes() for p in sorted(FIXTURES.glob("*lzw*.tiff"))]
    for data in files:
        np.testing.assert_array_equal(tiff.decode_tiff(data, native=True),
                                      tiff.decode_tiff(data))
    assert _lib.host_counts()["tiff_lzw"] >= len(files)   # one a strip
    bad = b"\xff\xff\xff\xff"    # the code 511 at once
    with pytest.raises(ValueError, match="corrupt TIFF LZW"):
        tiff.lzw_native(bad, 16)
    with pytest.raises(ValueError, match="corrupt TIFF LZW"):
        tiff.lzw_numpy(bad, 16)


def test_lung_ground_truth_matches_reference(tmp_path):
    """The lung dataset's depth_gt (scene_points through data.tiff, flipped
    with the frame) equals the JAX dataset's (PIL), items of a train split
    with flips."""
    rng = np.random.default_rng(4)
    seq = tmp_path / "seq1"
    gt = seq / "image_02" / "data" / "groundtruth"
    gt.mkdir(parents=True)
    for i in range(6):
        write_png(str(seq / f"{i:010d}.png"), picture(rng, 24, 32))
        depth = (rng.random((30, 40)) * 60 + 1).astype(np.float32)
        (gt / f"scene_points{i - 1:06d}.tiff").write_bytes(
            pil_tiff(depth, "tiff_lzw"))
    lines = [f"seq1 {i} l" for i in range(1, 5)]
    kw = dict(data_path=str(tmp_path), filenames=lines, height=16, width=32,
              frame_idxs=[0, -1, 1], is_train=True, load_depth=True,
              device_augment=True)
    port = datasets.make_dataset("endovis", **kw)
    ref = JD.LungRAWDataset(**kw)
    assert port.check_depth()
    flips = 0
    for i in range(len(lines)):
        a, b = port.get_item(i, 2), ref.get_item(i, 2)
        np.testing.assert_array_equal(a["depth_gt"], b["depth_gt"])
        np.testing.assert_array_equal(a["color"], b["color"])
        flips += not np.array_equal(a["depth_gt"], tiff.read_scene_points(
            str(gt / f"scene_points{i:06d}.tiff")))
    assert 0 < flips < len(lines)
    assert os.path.isfile(port._depth_path("seq1", 1, "l"))
