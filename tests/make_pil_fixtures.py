"""Write the PIL fixtures of the port's image codec to ``tests/data/pil/``:

    python tests/make_pil_fixtures.py

JPEGs of every layout ``data.jpeg`` reads (baseline and progressive, 4:4:4,
4:2:2, 4:2:0 and 4:1:1, restart markers, grey, RGB, odd and tiny sizes),
TIFFs of every layout ``data.tiff`` reads (each compression, II and MM,
strips and tiles, predictor 2), the rare PNGs (bit depths 1, 2 and 4,
16-bit colour, Adam7), and cases of the host jitter (a frame made from a
seed and its ``AugmentParams``). ``manifest.json`` holds, for each file or
case, the shape, dtype and SHA-256 of PIL's result: ``Image.open(f)`` as an
array for JPEG and TIFF, ``convert("RGB")`` (and its alpha where the file
has one) for PNG, the reference package's ``apply_augment`` for the
jitter. The machine with the card has no PIL: ``chip_smoke.py`` holds the
port to these answers there; the CPU tests compare with PIL directly.
The files were written with Pillow 12.1.0 (libjpeg-turbo 3.1.3, libtiff
4.7.1); rerun the script when Pillow changes.

The writers of the files PIL cannot write (``png_bytes``, ``tiff_bytes``)
are here too, for the tests.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "pil"

sys.path.insert(0, str(ROOT))
from unsupervised_pose_estimation_tpu_torch.data.png import (  # noqa: E402
    _COLOR_TYPES, ADAM7)


def png_bytes(samples: np.ndarray, color: int, depth: int,
              interlace: int = 0, plte=None, trns=None) -> bytes:
    """(H, W, C) integer samples -> a PNG of that colour type and bit depth
    (filter type 0 on every row), Adam7-interlaced if asked."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    def rows(sub):
        flat = sub.reshape(sub.shape[0], -1)
        if depth == 16:
            packed = flat.astype(">u2").view(np.uint8)
        elif depth == 8:
            packed = flat.astype(np.uint8)
        else:
            bits = np.unpackbits(flat.astype(np.uint8)[..., None], axis=-1)
            packed = np.packbits(bits[..., 8 - depth:].reshape(
                len(flat), -1), axis=-1)
        return b"".join(b"\x00" + r.tobytes() for r in packed)

    h, w = samples.shape[:2]
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(rows(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in passes
                   if samples[y0::dy, x0::dx].size)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        out += chunk(b"PLTE", bytes(np.asarray(plte, np.uint8)))
    if trns is not None:
        out += chunk(b"tRNS", bytes(np.asarray(trns, np.uint8)))
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def tiff_bytes(arr: np.ndarray, order: str = "<", tile=None,
               compression: int = 1, predictor: int = 1,
               photometric=None, extra_tags=()) -> bytes:
    """(H, W) or (H, W, S) samples -> a TIFF in byte order ``order`` ('<'
    II, '>' MM): one strip, or tiles of ``tile`` (w, h); compression 1
    (none), 8 (deflate) or 32773 (PackBits, literal runs); predictor 2
    differences the samples of each row; ``extra_tags``: more (tag, type,
    values) entries."""
    arr = arr if arr.ndim == 3 else arr[..., None]
    h, w, spp = arr.shape
    fmt = {"f": 3, "u": 1, "i": 2}[arr.dtype.kind]
    bits = arr.dtype.itemsize * 8
    tw, th = tile or (w, h)
    across, down = -(-w // tw), -(-h // th)
    padded = np.zeros((down * th, across * tw, spp), arr.dtype)
    padded[:h, :w] = arr
    chunks = []
    for k in range(across * down):
        r, c = divmod(k, across)
        rows = th if tile else min(th, h - r * th)
        block = padded[r * th:r * th + rows, c * tw:(c + 1) * tw]
        if predictor == 2:
            block = np.diff(block, axis=1, prepend=np.zeros_like(
                block[:, :1]))
        raw = block.astype(arr.dtype.newbyteorder(order)).tobytes()
        if compression == 8:
            raw = zlib.compress(raw)
        elif compression == 32773:
            raw = b"".join(bytes([len(raw[i:i + 128]) - 1]) + raw[i:i + 128]
                           for i in range(0, len(raw), 128))
        chunks.append(raw)
    offsets, at = [], 8
    for raw in chunks:
        offsets.append(at)
        at += len(raw)
    if photometric is None:
        photometric = 1 if spp == 1 else 2
    entries = [(256, 3, [w]), (257, 3, [h]), (258, 3, [bits] * spp),
               (259, 3, [compression]), (262, 3, [photometric]),
               (277, 3, [spp]), (339, 3, [fmt] * spp)]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if spp == 4:
        entries.append((338, 3, [2]))
    entries += list(extra_tags)
    if tile:
        entries += [(322, 3, [tw]), (323, 3, [th]), (324, 4, offsets),
                    (325, 4, [len(c) for c in chunks])]
    else:
        entries += [(273, 4, offsets), (278, 3, [th]),
                    (279, 4, [len(c) for c in chunks])]
    entries.sort()
    pad = b"\x00" * (at & 1)   # the IFD on a word boundary
    ifd = at + len(pad)
    extra_at = ifd + 2 + 12 * len(entries) + 4
    body, extra = b"", b""
    for tag, kind, values in entries:
        code, size = ("H", 2) if kind == 3 else ("I", 4)
        payload = struct.pack(order + code * len(values), *values)
        if len(payload) <= 4:
            field = payload.ljust(4, b"\x00")
        else:
            field = struct.pack(order + "I", extra_at + len(extra))
            extra += payload
        body += struct.pack(order + "HHI", tag, kind, len(values)) + field
    head = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(
        order + "I", ifd)
    return (head + b"".join(chunks) + pad
            + struct.pack(order + "H", len(entries))
            + body + b"\x00" * 4 + extra)


def picture(rng, h, w, c=3):
    """A smooth picture with mild noise (small JPEGs)."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 5.0 + k) * 60 + np.cos(yy / 4.0 - k) * 50
                     + 128 for k in range(c)], -1)
    pix = base + rng.normal(0, 6, (h, w, c))
    return np.clip(pix, 0, 255).astype(np.uint8)


def jpeg_fixtures(rng):
    """-> {name: bytes}, each written by Pillow (or, for 4:1:1, which
    Pillow's subsampling option maps to 4:2:0, by data.jpeg.encode_jpeg)."""
    from PIL import Image

    from unsupervised_pose_estimation_tpu_torch.data.jpeg import encode_jpeg

    def pil(arr, **kwargs):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", **kwargs)
        return buf.getvalue()

    img = picture(rng, 35, 51)
    out = {}
    for sub in ("4:4:4", "4:2:2", "4:2:0"):
        tag = sub.replace(":", "")
        out[f"base_{tag}.jpg"] = pil(img, subsampling=sub)
        out[f"prog_{tag}.jpg"] = pil(img, subsampling=sub, progressive=True)
    out["base_420_q50.jpg"] = pil(img, quality=50)
    out["base_420_q95.jpg"] = pil(img, quality=95)
    out["base_411.jpg"] = encode_jpeg(img, sampling=(4, 1))
    out["rst_blocks_420.jpg"] = pil(img, restart_marker_blocks=3)
    out["rst_rows_prog_422.jpg"] = pil(img, subsampling="4:2:2",
                                       progressive=True,
                                       restart_marker_rows=1)
    out["grey_base.jpg"] = pil(img[..., 1])
    out["grey_prog.jpg"] = pil(img[..., 1], progressive=True)
    out["rgb_keep.jpg"] = pil(img, keep_rgb=True)
    out["tiny_1x1_420.jpg"] = pil(img[:1, :1])
    out["tiny_3x5_prog_420.jpg"] = pil(img[:3, :5], progressive=True)
    out["tiny_2x17_422.jpg"] = pil(img[:2, :17], subsampling="4:2:2")
    return out


def tiff_fixtures(rng):
    """-> {name: bytes}: Pillow's writes (II, one strip of each
    compression) and hand-made MM, tile and predictor files."""
    from PIL import Image

    def pil(arr, compression, **kwargs):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "TIFF", compression=compression,
                                  **kwargs)
        return buf.getvalue()

    h, w = 24, 40
    depth = (rng.random((h, w)) * 50 + 1).astype(np.float32)
    u16 = (np.add.outer(np.arange(h), np.arange(w)) * 300).astype(np.uint16)
    i32 = rng.integers(-10 ** 6, 10 ** 6, (h, w)).astype(np.int32)
    u8 = rng.integers(0, 256, (h, w), np.uint8)
    rgb = picture(rng, h, w)
    rgba = picture(rng, h, w, 4)
    out = {}
    for comp in ("raw", "tiff_deflate", "tiff_lzw", "packbits"):
        out[f"f32_{comp}.tiff"] = pil(depth, comp)
    out["u16_lzw_pred2.tiff"] = pil(u16, "tiff_lzw", tiffinfo={317: 2})
    out["u16_deflate.tiff"] = pil(u16, "tiff_deflate")
    out["i32_lzw.tiff"] = pil(i32, "tiff_lzw")
    out["u8_packbits.tiff"] = pil(u8, "packbits")
    out["rgb_lzw_pred2.tiff"] = pil(rgb, "tiff_lzw", tiffinfo={317: 2})
    out["rgba_deflate.tiff"] = pil(rgba, "tiff_deflate")
    out["f32_mm.tiff"] = tiff_bytes(depth, ">")
    out["f32_mm_deflate_tiles.tiff"] = tiff_bytes(depth, ">", (16, 16), 8)
    out["u16_mm_deflate_pred2.tiff"] = tiff_bytes(u16, ">", None, 8, 2)
    out["f32_tiles.tiff"] = tiff_bytes(depth, "<", (16, 16))
    out["rgb_tiles_deflate_pred2.tiff"] = tiff_bytes(rgb, "<", (16, 16), 8,
                                                     2)
    out["i32_mm_packbits.tiff"] = tiff_bytes(i32, ">", None, 32773)
    return out


# the PNGs PIL reads that are not 8-bit and not interlaced: grey 1/2/4,
# palette 1/2/4, 16-bit RGB, grey + alpha and RGBA; and Adam7 of every
# colour type at every depth
PNG_FORMATS = [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 4), (2, 16),
               (4, 16), (6, 16)]
ALL_PNG_FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
                   (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
                   (6, 16)]


def png_case(rng, color, depth, interlace, h=13, w=21):
    """A PNG of random samples of that format (palettes of 2^depth random
    entries, half of them with a tRNS chunk)."""
    samples = rng.integers(0, 1 << depth, (h, w, _COLOR_TYPES[color][0]))
    plte = trns = None
    if color == 3:
        plte = rng.integers(0, 256, (1 << depth) * 3)
        if rng.random() < 0.5:
            trns = rng.integers(0, 256, min(1 << depth, 5))
    return png_bytes(samples, color, depth, interlace, plte, trns)


def png_fixtures(rng):
    out = {}
    for color, depth in PNG_FORMATS:
        out[f"c{color}_d{depth}.png"] = png_case(rng, color, depth, 0)
    for color, depth in ALL_PNG_FORMATS:
        out[f"c{color}_d{depth}_adam7.png"] = png_case(rng, color, depth, 1)
    return out


def jitter_frame(seed: int, h: int, w: int, flat=None) -> np.ndarray:
    """A jitter case's input: uniform noise from ``seed`` with, if ``flat``
    = (channel, value), one channel set to a constant."""
    frame = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    if flat is not None:
        frame[..., flat[0]] = flat[1]
    return frame


JITTER_CASES = [
    dict(seed=1, shape=[24, 40], flat=None, params=[1.2, 0.8, 1.2, 0.1, True]),
    dict(seed=2, shape=[24, 40], flat=None,
         params=[0.8, 1.2, 0.8, -0.1, False]),
    dict(seed=3, shape=[17, 29], flat=[1, 77],
         params=[1.05, 0.93, 1.11, 0.037, True]),
    dict(seed=4, shape=[17, 29], flat=[2, 0],
         params=[0.91, 1.07, 0.86, -0.062, True]),
    dict(seed=5, shape=[32, 32], flat=None, params=[1.0, 1.0, 1.0, 0.0, True]),
    dict(seed=6, shape=[9, 64], flat=[0, 255],
         params=[1.17, 1.19, 0.81, 0.0999, False]),
]


def jitter_params(case):
    b, c, s, hue, auto = case["params"]
    return dict(enabled=True, brightness=b, contrast=c, saturation=s,
                hue=hue, autocontrast=auto)


def record(arr: np.ndarray) -> dict:
    """Shape, dtype and SHA-256 of ``arr`` in native byte order."""
    arr = np.ascontiguousarray(arr, arr.dtype.newbyteorder("="))
    return dict(shape=list(arr.shape), dtype=arr.dtype.name,
                sha256=hashlib.sha256(arr.tobytes()).hexdigest())


def pil_result(name: str, data: bytes) -> dict:
    """PIL's answer for a fixture file (see the module's docstring)."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        if name.endswith(".png"):
            out = {"rgb": record(np.asarray(img.convert("RGB")))}
            if img.mode in ("LA", "RGBA", "PA") or (
                    img.mode == "P" and "transparency" in img.info):
                out["alpha"] = record(np.asarray(img.convert("RGBA"))[..., 3])
            return out
        return {"array": record(np.asarray(img))}


def main():
    from PIL import Image, features

    from unsupervised_pose_estimation_tpu.data.augment import (
        AugmentParams, apply_augment)

    rng = np.random.default_rng(2024)
    files = {**jpeg_fixtures(rng), **tiff_fixtures(rng), **png_fixtures(rng)}
    OUT.mkdir(parents=True, exist_ok=True)
    for old in OUT.iterdir():
        old.unlink()
    manifest = {"pillow": Image.__version__,
                "libjpeg": features.version("jpg"),
                "libtiff": features.version("libtiff"),
                "files": {}, "jitter": []}
    for name, data in sorted(files.items()):
        (OUT / name).write_bytes(data)
        manifest["files"][name] = pil_result(name, data)
    for case in JITTER_CASES:
        frame = jitter_frame(case["seed"], *case["shape"], case["flat"])
        want = np.asarray(apply_augment(Image.fromarray(frame), AugmentParams(
            **jitter_params(case))), np.uint8)
        manifest["jitter"].append({**case, "output": record(want)})
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(files)} files and {len(JITTER_CASES)} jitter cases, "
          f"{size / 1024:.1f} KiB, in {os.path.relpath(OUT)}")


if __name__ == "__main__":
    main()
