"""The port's image codec held against PIL and matplotlib: ``data.png``
(decode, ``to_rgb``, encode), ``data.resample`` (PIL's LANCZOS and its
NEAREST on 16-bit grey), ``data.colormap`` (matplotlib's magma) and
``data.jpeg`` (read back by PIL), all bit for bit except the JPEG, which
is lossy and held to a stated bound. Where ``g++`` is installed, the native
host routines of ``csrc/image_host.cpp`` are built with it into the test's
temporary directory and held to the numpy routes bit for bit."""

import ctypes
import io
import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import matplotlib
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from unsupervised_pose_estimation_tpu_torch.data import png, resample
from unsupervised_pose_estimation_tpu_torch.data.colormap import magma_u8
from unsupervised_pose_estimation_tpu_torch.data.jpeg import encode_jpeg
from unsupervised_pose_estimation_tpu_torch.ops.kernels import _lib

ROOT = Path(__file__).resolve().parents[1]
# the shapes of the feeds: SCARED after its crop, KITTI, 480x640, and
# upscaling, odd, tiny and unchanged sizes ((h, w) -> (out_h, out_w))
LANCZOS_SHAPES = [((960, 1280), (192, 640)), ((375, 1242), (192, 640)),
                  ((480, 640), (192, 640)), ((32, 32), (64, 48)),
                  ((7, 13), (5, 29)), ((1, 5), (3, 2)), ((20, 30), (20, 30))]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def textured(rng, h, w, c):
    """A smooth picture with noise: PIL's adaptive filters pick every
    type on it (Sub, Up, Average, Paeth and None)."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 9.0) + np.cos(yy / 7.0)) * 50 + 128
    pix = base[..., None] + rng.normal(0, 8, (h, w, c))
    return np.clip(pix, 0, 255).astype(np.uint8)


def pil_png(img, **kwargs):
    buf = io.BytesIO()
    img.save(buf, "PNG", **kwargs)
    return buf.getvalue()


def filter_types(data):
    """The filter types of a PNG's rows (8-bit, not interlaced)."""
    pix = png.decode_png(data)
    stride = pix.shape[1] * (pix.shape[2] if pix.ndim == 3 else 1) * \
        pix.dtype.itemsize
    idat = b"".join(body for kind, body in png._chunks(data)
                    if kind == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw[::stride + 1][:pix.shape[0]].tolist())


@pytest.mark.parametrize("mode,channels", [("L", 1), ("LA", 2), ("RGB", 3),
                                           ("RGBA", 4)])
def test_decode_matches_pil(mode, channels):
    """decode_png + to_rgb is Image.open(f).convert("RGB") on PIL-written
    files, optimize off and on, from 1x1 to 1280x1024."""
    rng = np.random.default_rng(channels)
    sizes = [(1, 1), (3, 7), (48, 64)]
    if mode in ("L", "RGB"):
        sizes.append((1024, 1280))
    seen = set()
    for h, w in sizes:
        pix = textured(rng, h, w, channels)
        img = Image.fromarray(pix[..., 0] if channels == 1 else pix, mode)
        for optimize in (False, True):
            data = pil_png(img, optimize=optimize)
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            got = png.to_rgb(png.decode_png(data))
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")
            seen |= filter_types(data)
    assert seen == {0, 1, 2, 3, 4}  # every filter type was reversed


def test_palette_matches_pil():
    rng = np.random.default_rng(5)
    img = Image.fromarray(rng.integers(0, 256, (30, 41), np.uint8), "L")
    img = img.convert("P")
    img.putpalette(rng.integers(0, 256, 768, np.uint8).tolist())
    for kwargs in ({}, {"optimize": True},
                   {"transparency": bytes(range(0, 250, 2))}):
        data = pil_png(img, **kwargs)
        with Image.open(io.BytesIO(data)) as ref:
            assert ref.mode == "P"
            want = np.asarray(ref.convert("RGB"))
        np.testing.assert_array_equal(png.to_rgb(png.decode_png(data)), want)


def test_16bit_grey_matches_pil():
    """decode_png of I;16 is np.asarray(Image.open(f)): KITTI's annotated
    depth maps, and random values."""
    rng = np.random.default_rng(6)
    depth = textured(rng, 370, 1224, 1)[..., 0].astype(np.uint16) * 200
    for arr in (depth, rng.integers(0, 65536, (37, 51), dtype=np.uint16)):
        data = pil_png(Image.fromarray(arr))
        with Image.open(io.BytesIO(data)) as ref:
            assert ref.mode == "I;16"
            want = np.asarray(ref)
        got = png.decode_png(data)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, want)


def test_encoder_round_trips_each_filter_type():
    """encode_png with each forced filter type, mixed per-row types and the
    adaptive choice: decode_png and PIL read back the same pixels."""
    rng = np.random.default_rng(7)
    arrays = [textured(rng, 45, 67, 3), textured(rng, 45, 67, 1)[..., 0],
              rng.integers(0, 65536, (45, 67), dtype=np.uint16)]
    mixed = rng.integers(0, 5, 45)
    for arr in arrays:
        for kind in (0, 1, 2, 3, 4, mixed, None):
            data = png.encode_png(arr, filter=kind)
            if kind is not None:
                assert filter_types(data) == set(np.atleast_1d(kind).tolist())
            np.testing.assert_array_equal(png.decode_png(data), arr)
            np.testing.assert_array_equal(
                np.asarray(Image.open(io.BytesIO(data))), arr)


def with_ihdr(data, **fields):
    """``data`` with IHDR fields replaced (CRC recomputed)."""
    names = ("width", "height", "depth", "color", "compression", "filter",
             "interlace")
    values = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    values.update(fields)
    body = struct.pack(">IIBBBBB", *(values[n] for n in names))
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    return data[:16] + body + crc + data[33:]


def with_filter_byte(data, row, value):
    """An 8-bit grey PNG ``data`` with row ``row``'s filter type set to
    ``value`` (the IDAT stream recompressed)."""
    pix = png.decode_png(data)
    stride = pix.shape[1]
    raw = bytearray(zlib.decompress(b"".join(
        body for kind, body in png._chunks(data) if kind == b"IDAT")))
    raw[row * (stride + 1)] = value
    body = zlib.compress(bytes(raw))
    chunk = struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(
        ">I", zlib.crc32(b"IDAT" + body))
    return data[:33] + chunk + data[-12:]


def test_refuses_what_it_does_not_read():
    data = png.encode_png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="interlace"):
        png.decode_png(with_ihdr(data, interlace=1))
    with pytest.raises(ValueError, match="colour type 2 at bit depth 16"):
        png.decode_png(with_ihdr(data, depth=16))
    one_bit = pil_png(Image.fromarray(np.eye(8, dtype=bool)))
    with pytest.raises(ValueError, match="colour type 0 at bit depth 1"):
        png.decode_png(one_bit)
    broken = bytearray(data)
    broken[40] ^= 1  # inside the IDAT body
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(broken))
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + data[6:])
    bad_type = with_filter_byte(png.encode_png(np.zeros((2, 2), np.uint8)),
                                1, 9)
    with pytest.raises(ValueError, match="filter type 9"):
        png.decode_png(bad_type)


def lanczos_pair(rng, h, w, out_h, out_w, c=3):
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    pil = Image.fromarray(img[..., 0] if c == 1 else img)
    want = np.asarray(pil.resize((out_w, out_h), Image.LANCZOS))
    return img[..., 0] if c == 1 else img, want


def test_lanczos_matches_pil():
    rng = np.random.default_rng(8)
    for (h, w), (out_h, out_w) in LANCZOS_SHAPES:
        img, want = lanczos_pair(rng, h, w, out_h, out_w)
        np.testing.assert_array_equal(resample.resize_lanczos(img, out_h,
                                                              out_w), want)


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70), out_h=st.integers(1, 70),
       out_w=st.integers(1, 70), grey=st.booleans(), seed=st.integers(0, 99))
def test_lanczos_matches_pil_on_drawn_shapes(h, w, out_h, out_w, grey, seed):
    img, want = lanczos_pair(np.random.default_rng(seed), h, w, out_h, out_w,
                             1 if grey else 3)
    np.testing.assert_array_equal(resample.resize_lanczos(img, out_h, out_w),
                                  want)


def test_nearest_matches_pil_on_16bit():
    rng = np.random.default_rng(9)
    for (h, w), (out_h, out_w) in [((370, 1224), (375, 1242)),
                                   ((376, 1241), (375, 1242)),
                                   ((375, 1242), (375, 1242)),
                                   ((37, 51), (100, 20)), ((37, 51), (13, 99))]:
        depth = rng.integers(0, 65536, (h, w), dtype=np.uint16)
        pil = Image.fromarray(depth)
        assert pil.mode == "I;16"
        want = np.asarray(pil.resize((out_w, out_h), Image.NEAREST))
        np.testing.assert_array_equal(
            resample.resize_nearest_pil(depth, out_h, out_w), want)


@pytest.fixture
def gcc_library(tmp_path, monkeypatch):
    """csrc/image_host.cpp built with g++ in tmp_path and put where
    ``_lib.library()`` returns it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the native routines are held "
                    "to numpy on the card (chip_smoke.py phase 12)")
    out = tmp_path / "libimage_host.so"
    src = ROOT / "unsupervised_pose_estimation_tpu_torch" / "csrc" / \
        "image_host.cpp"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-o",
                    str(out), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    _lib.declare(lib, _lib.HOST_SIGNATURES)
    monkeypatch.setattr(_lib, "_lib", lib)
    _lib.reset_counts()
    return lib


def test_native_routines_match_numpy(gcc_library):
    """The unfilter on each forced and mixed filter type of every colour
    type read, the LANCZOS passes on the feeds' shapes: the same bytes."""
    rng = np.random.default_rng(10)
    arrays = [textured(rng, 64, 80, 3), textured(rng, 33, 7, 1)[..., 0],
              rng.integers(0, 65536, (19, 23), dtype=np.uint16)]
    n = 0
    for arr in arrays:
        for kind in (0, 1, 2, 3, 4, rng.integers(0, 5, arr.shape[0]), None):
            data = png.encode_png(arr, filter=kind)
            np.testing.assert_array_equal(png.decode_png(data, native=True),
                                          png.decode_png(data))
            n += 1
    for mode, c in (("LA", 2), ("RGBA", 4)):
        data = pil_png(Image.fromarray(textured(rng, 21, 34, c), mode))
        np.testing.assert_array_equal(png.decode_png(data, native=True),
                                      png.decode_png(data))
        n += 1
    for (h, w), (out_h, out_w) in LANCZOS_SHAPES:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            resample.resize_lanczos(img, out_h, out_w, native=True),
            resample.resize_lanczos(img, out_h, out_w))
    counts = _lib.host_counts()
    assert counts["png_unfilter"] == n
    assert counts["resample_horizontal_u8"] == 5  # widths that change
    assert counts["resample_vertical_u8"] == 6   # heights that change
    with pytest.raises(ValueError, match="filter type 7"):
        png.decode_png(with_filter_byte(
            png.encode_png(np.zeros((3, 3), np.uint8)), 1, 7), native=True)


def test_magma_matches_matplotlib():
    cmap = matplotlib.colormaps["magma"]
    rng = np.random.default_rng(11)
    for dtype in (np.float32, np.float64):
        x = rng.random((64, 80)).astype(dtype)
        x[0, :6] = [0.0, 1.0, 0.5, 1 / 256, 255 / 256, np.nan]
        want = (cmap(x)[..., :3] * 255).astype(np.uint8)
        np.testing.assert_array_equal(magma_u8(x), want)


def test_jpeg_reads_back_within_bound():
    """PIL decodes encode_jpeg's bytes (odd sizes, a 1x1, a whole frame)
    to within mean 3 and max 40 of a smooth input, and on smooth and noisy
    inputs to within 0.25 of the mean error of Pillow's own quality-75
    JPEG of the same image."""
    rng = np.random.default_rng(12)
    for h, w in ((1, 1), (17, 33), (40, 56), (192, 640)):
        yy, xx = np.mgrid[0:h, 0:w]
        smooth = np.stack([np.sin(xx / 9.0) * 100 + 128,
                           np.cos(yy / 5.0) * 100 + 128,
                           xx * 255.0 / max(w - 1, 1)], -1).astype(np.uint8)
        for rgb in (smooth, textured(rng, h, w, 3)):
            with Image.open(io.BytesIO(encode_jpeg(rgb))) as img:
                assert (img.format, img.mode, img.size) == ("JPEG", "RGB",
                                                            (w, h))
                err = np.abs(np.asarray(img).astype(int) - rgb)
            buf = io.BytesIO()
            Image.fromarray(rgb).save(buf, "JPEG")
            pil_err = np.abs(np.asarray(Image.open(buf)).astype(int) - rgb)
            assert err.mean() <= pil_err.mean() + 0.25, (h, w)
            if rgb is smooth:
                assert err.mean() <= 3 and err.max() <= 40, (h, w)
