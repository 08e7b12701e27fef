"""The port's JPEG codec (``data.jpeg``) held to Pillow 12.1.0 (libjpeg-turbo
3.1.3) bit for bit: the decoder on every fixture of ``tests/data/pil`` and on
files Pillow writes at drawn sizes, subsamplings, qualities, progressive or
not, with restart markers; the native host routines (built with ``g++``
here) against numpy; the refusals; ``encode_jpeg``'s bytes against
Pillow's ``save()``; and ``cli.test_simple``'s ``_disp.jpg`` against the
JAX package's file for the same disparity."""

import io
import os
import struct
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from tests.make_pil_fixtures import picture
from tests.test_torch_image_io import gcc_library  # noqa: F401
from unsupervised_pose_estimation_tpu.cli import test_simple as JTS
from unsupervised_pose_estimation_tpu_torch.cli import test_simple as TS
from unsupervised_pose_estimation_tpu_torch.data import jpeg
from unsupervised_pose_estimation_tpu_torch.data.colormap import magma_u8
from unsupervised_pose_estimation_tpu_torch.data.png import (decode_image,
                                                             write_png)
from unsupervised_pose_estimation_tpu_torch.ops.kernels import _lib

FIXTURES = Path(__file__).resolve().parent / "data" / "pil"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pil_jpeg(arr, **kwargs):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


def pil_pixels(data):
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img)


def fixture_files():
    return sorted(FIXTURES.glob("*.jpg"))


def test_decoder_matches_pil_on_fixtures():
    """Baseline and progressive, 4:4:4 / 4:2:2 / 4:2:0 / 4:1:1, qualities
    50-95, restart markers, grey, RGB (Adobe), 1x1, 3x5 and 2x17 files."""
    files = fixture_files()
    assert len(files) == 17
    for path in files:
        data = path.read_bytes()
        got, want = jpeg.decode_jpeg(data), pil_pixels(data)
        assert got.dtype == want.dtype and got.shape == want.shape, path.name
        np.testing.assert_array_equal(got, want, err_msg=path.name)
        np.testing.assert_array_equal(
            decode_image(data), np.asarray(Image.open(path).convert("RGB")))


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 67), w=st.integers(1, 93),
       sub=st.sampled_from(["4:4:4", "4:2:2", "4:2:0"]),
       progressive=st.booleans(), restart=st.sampled_from([0, 1, 5]),
       quality=st.sampled_from([50, 75, 95]), grey=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_decoder_matches_pil_on_drawn_files(h, w, sub, progressive, restart,
                                            quality, grey, seed):
    img = picture(np.random.default_rng(seed), h, w)
    kwargs = dict(subsampling=sub, progressive=progressive, quality=quality)
    if restart:
        kwargs["restart_marker_blocks"] = restart
    data = pil_jpeg(img[..., 0] if grey else img, **kwargs)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), pil_pixels(data))


def test_luma_4x1_matches_pil():
    """4:1:1 (luma 4x1, chroma replicated): files written by encode_jpeg
    (Pillow's "4:1:1" writes 4:2:0), down to widths of 1-3 chroma
    samples."""
    rng = np.random.default_rng(3)
    for h, w in ((1, 1), (9, 5), (17, 11), (31, 70)):
        data = jpeg.encode_jpeg(picture(rng, h, w), sampling=(4, 1))
        np.testing.assert_array_equal(jpeg.decode_jpeg(data),
                                      pil_pixels(data))


def test_native_matches_numpy(gcc_library):
    """The native entropy decoding and pixel stage give numpy's bytes on
    every fixture and on a 480x640 frame; each counts its calls."""
    datas = [p.read_bytes() for p in fixture_files()]
    datas.append(jpeg.encode_jpeg(picture(np.random.default_rng(4), 480,
                                          640)))
    for data in datas:
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, native=True),
                                      jpeg.decode_jpeg(data))
    counts = _lib.host_counts()
    assert counts["jpeg_pixels"] == len(datas)
    assert counts["jpeg_entropy"] > len(datas)      # a call per scan
    truncated = datas[-1][:len(datas[-1]) // 2]
    for native in (True, False):
        with pytest.raises(ValueError, match="truncated"):
            jpeg.decode_jpeg(truncated, native=native)


def with_sof(data, **fields):
    """``data`` with fields of its SOF segment replaced: marker, precision,
    luma (the first component's sampling byte)."""
    at = next(i for i in range(2, len(data) - 1)
              if data[i] == 0xFF and 0xC0 <= data[i + 1] <= 0xC2)
    out = bytearray(data)
    if "marker" in fields:
        out[at + 1] = fields["marker"]
    if "precision" in fields:
        out[at + 4] = fields["precision"]
    if "luma" in fields:
        out[at + 11] = fields["luma"]
    return bytes(out)


def test_refuses_what_it_does_not_read():
    rng = np.random.default_rng(5)
    img = picture(rng, 20, 24)
    base = pil_jpeg(img, subsampling="4:4:4")
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    cmyk = buf.getvalue()
    cases = [
        (with_sof(base, marker=0xC9), "arithmetic"),
        (with_sof(base, marker=0xC3), "lossless"),
        (with_sof(base, precision=12), "12-bit"),
        (with_sof(base, luma=0x12), r"sampling factors \[\(1, 2\)"),
        (with_sof(base, luma=0x31), r"sampling factors \[\(3, 1\)"),
        (cmyk, "CMYK"),
        (base[:len(base) * 2 // 3], "truncated"),
        (base[:30], "truncated JPEG segment"),
        (b"\x89PNG" + base[4:], "not a JPEG"),
    ]
    # a progressive file without its last scans: bits left unknown
    prog = pil_jpeg(img, progressive=True)
    sos = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    cases.append((prog[:sos[-3]] + b"\xff\xd9", "bits unknown"))
    for data, match in cases:
        with pytest.raises(ValueError, match=match):
            jpeg.decode_jpeg(data)


@pytest.mark.parametrize("sub,sampling", [("4:2:0", (2, 2)),
                                          ("4:2:2", (2, 1)),
                                          ("4:4:4", (1, 1))])
def test_encoder_writes_pillows_bytes(sub, sampling):
    """encode_jpeg's file is Pillow's save() at its defaults, byte for
    byte, on random and magma images at sizes that are not multiples of the
    MCU (and 1x1)."""
    rng = np.random.default_rng(6)
    for h, w in ((1, 1), (7, 100), (17, 19), (33, 47), (96, 160)):
        yy, xx = np.mgrid[0:h, 0:w]
        magma = magma_u8((np.sin(xx / 7.0) + np.cos(yy / 5.0) + 2) / 4)
        for img in (rng.integers(0, 256, (h, w, 3), np.uint8), magma):
            want = pil_jpeg(img, subsampling=sub)
            assert jpeg.encode_jpeg(img, sampling) == want, (h, w)


def test_disp_jpg_equals_reference(tmp_path, monkeypatch):
    """cli.test_simple's _disp.jpg is the JAX CLI's file byte for byte, given
    the same disparity (each CLI's network replaced by it), at a 64x64
    feed, for a 64x64 and a 70x90 image."""
    size = 64
    disp = np.random.default_rng(7).random((1, size, size, 1)).astype(
        np.float32) * 0.3 + 0.01
    folders = {}
    for side in ("jax", "port"):
        folder = tmp_path / side
        folder.mkdir()
        for name, (h, w) in (("a", (64, 64)), ("b", (70, 90))):
            write_png(str(folder / f"{name}.png"), picture(
                np.random.default_rng(h), h, w))
        folders[side] = folder
    monkeypatch.setattr(JTS, "build_infer_step",
                        lambda bundle: lambda *args: [disp])
    monkeypatch.setattr(
        "unsupervised_pose_estimation_tpu.eval.evaluate_depth."
        "load_eval_state", lambda opt: (None, types.SimpleNamespace(
            params=None, batch_stats=None)))
    monkeypatch.setattr(TS, "build_infer_step",
                        lambda bundle: lambda x: [torch.from_numpy(disp)])
    monkeypatch.setattr(TS, "load_eval_state",
                        lambda opt, device: torch.nn.Linear(1, 1))
    args = ["--model_path", str(tmp_path), "--height", str(size),
            "--width", str(size)]
    JTS.main(["--image_path", str(folders["jax"])] + args)
    TS.main(["--image_path", str(folders["port"])] + args, device="cpu")
    for name in ("a", "b"):
        want = (folders["jax"] / f"{name}_disp.jpg").read_bytes()
        got = (folders["port"] / f"{name}_disp.jpg").read_bytes()
        assert got == want, name
        assert os.path.getsize(folders["port"] / f"{name}_disp.npy") > 0


def test_segments_and_markers():
    """Fill bytes before markers, a COM segment and an APP segment are
    skipped; restart markers split the scan into as many segments as its
    interval asks."""
    img = picture(np.random.default_rng(8), 16, 40)
    data = pil_jpeg(img, restart_marker_blocks=1, subsampling="4:4:4")
    padded = data[:2] + b"\xff\xfe" + struct.pack(">H", 7) + b"hello" + \
        b"\xff\xe5\x00\x04ab" + b"\xff\xff" + data[2:]
    np.testing.assert_array_equal(jpeg.decode_jpeg(padded),
                                  pil_pixels(data))
    _, seg, _ = jpeg._entropy_data(data, data.index(b"\xff\xda") + 14)
    assert len(seg) - 1 == 10   # 2 x 5 MCUs, one restart interval each
