"""A PNG codec in numpy, in place of PIL's PNG plugin.

``decode_png`` reads the files the datasets, the server and the command-line
tools take: colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha)
and 6 (RGBA) at bit depth 8, and grey at bit depth 16. It checks every
chunk's CRC, inflates the IDAT stream with ``zlib`` and reverses the five
filter types. The unfilter has two routes with the same bytes: the numpy
one (``unfilter_numpy``), and the native host routine of
``csrc/image_host.cpp`` (``native=True``), which entry points on a CUDA
device take (``ops.kernels._lib.native_route``). ``to_rgb`` is PIL's
``convert("RGB")``. ``encode_png`` writes 8-bit grey, grey + alpha, RGB
and RGBA and 16-bit grey, with one filter type forced on every row when
asked.

``decode_image`` is the entry for a file of any format: PNG through
``decode_png``, anything else through PIL, imported only then.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PIL's limit (Image.MAX_IMAGE_PIXELS * 2, where it raises
# DecompressionBombError): a server reads untrusted headers
MAX_PIXELS = 2 * 89478485
# colour type -> (channels, bit depths read)
_COLOR_TYPES = {0: (1, (8, 16)), 2: (3, (8,)), 3: (1, (8,)), 4: (2, (8,)),
                6: (4, (8,))}


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    if not is_png(data):
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length


def unfilter_numpy(raw: np.ndarray, rows: int, stride: int,
                   bpp: int) -> np.ndarray:
    """Reverse the filters of ``rows`` scanlines of ``stride`` bytes (each
    after its filter-type byte in ``raw``) -> (rows, stride) uint8.

    A pixel depends on its left, upper and upper-left neighbours, so the
    pixels are taken by anti-diagonals (row + column constant): each
    diagonal is one vectorised step over all the rows it crosses, whatever
    each row's filter type."""
    lines = raw[:rows * (stride + 1)].reshape(rows, stride + 1)
    types = lines[:, 0].astype(np.int16)
    if rows and types.max() > 4:
        bad = int(np.argmax(types > 4))
        raise ValueError(f"PNG row {bad} has filter type {types[bad]} "
                         "(not 0-4)")
    width = stride // bpp
    pix = lines[:, 1:].reshape(rows, width, bpp).astype(np.int16)
    steps = rows + width - 1
    r_idx = np.arange(rows)[:, None]
    x_idx = np.arange(width)[None, :]
    # skewed: step t of row r holds pixel t - r; q[t + 2, r + 1] is step
    # t's pixel of row r, so q[., 0] (the row above row 0) and the two
    # steps before step 0 stay zero
    skew = np.zeros((max(steps, 0), rows, bpp), np.int16)
    skew[r_idx + x_idx, r_idx] = pix
    q = np.zeros((steps + 2, rows + 1, bpp), np.int16)
    for t in range(steps):
        r0, r1 = max(0, t - width + 1), min(rows, t + 1)
        a = q[t + 1, r0 + 1:r1 + 1]   # left: (r, x - 1)
        b = q[t + 1, r0:r1]           # up: (r - 1, x)
        c = q[t, r0:r1]               # up-left: (r - 1, x - 1)
        f = types[r0:r1, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        q[t + 2, r0 + 1:r1 + 1] = (skew[t, r0:r1] + pred) & 0xFF
    out = q[r_idx + x_idx + 2, r_idx + 1]
    return out.astype(np.uint8).reshape(rows, stride)


def unfilter_native(raw: np.ndarray, rows: int, stride: int,
                    bpp: int) -> np.ndarray:
    """``unfilter_numpy`` through the native host routine."""
    from ..ops.kernels import _lib

    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size < rows * (stride + 1):
        raise ValueError("PNG image data is shorter than its rows")
    out = np.empty((rows, stride), np.uint8)
    code = _lib.call_host("png_unfilter", "upe_png_unfilter",
                          raw.ctypes.data, rows, stride, bpp,
                          out.ctypes.data)
    if code != 0:
        raise ValueError(f"PNG row {code - 1} has filter type "
                         f"{raw[(code - 1) * (stride + 1)]} (not 0-4)")
    return out


def decode_png(data: bytes, native: bool = False) -> np.ndarray:
    """PNG bytes -> pixels: (H, W) grey (uint8, or big-endian 16-bit as
    uint16), (H, W, 2) grey + alpha, (H, W, 3) RGB, (H, W, 4) RGBA; a
    palette image comes back through its palette as (H, W, 3), or (H, W, 4)
    with the tRNS alphas. ``native`` takes the native unfilter. Raises
    ``ValueError`` on a malformed file or one it does not read (Adam7
    interlace, bit depths 1, 2 and 4, 16-bit colour)."""
    header = palette = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if not 0 < width * height <= MAX_PIXELS:
        raise ValueError(f"PNG of {width}x{height} pixels (at most "
                         f"{MAX_PIXELS} are read)")
    if color not in _COLOR_TYPES or depth not in _COLOR_TYPES[color][1]:
        raise ValueError(f"PNG colour type {color} at bit depth {depth} is "
                         "not read here (8-bit grey, RGB, palette, grey + "
                         "alpha, RGBA, and 16-bit grey are)")
    if interlace != 0:
        raise ValueError(f"PNG interlace method {interlace} (Adam7) is not "
                         "read here")
    if color == 3 and palette is None:
        raise ValueError("palette PNG has no PLTE chunk")
    channels = _COLOR_TYPES[color][0]
    bpp = channels * depth // 8
    stride = width * bpp
    # inflate no more than the rows need
    need = height * (stride + 1)
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as err:
        raise ValueError(f"PNG image data does not inflate: {err}") from err
    raw = np.frombuffer(raw, np.uint8)
    if raw.size < need:
        raise ValueError("PNG image data is shorter than its rows")
    unfilter = unfilter_native if native else unfilter_numpy
    pix = unfilter(raw, height, stride, bpp)
    if depth == 16:
        return pix.reshape(height, width, 2).view(">u2")[..., 0].astype(
            np.uint16)
    pix = pix.reshape(height, width, channels)
    if color == 3:
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        palette = palette[:256]
        table[:len(palette), :3] = palette
        if trns is None:
            return table[pix[..., 0], :3]
        table[:len(trns[:256]), 3] = trns[:256]
        return table[pix[..., 0]]
    return pix[..., 0] if channels == 1 else pix


def to_rgb(arr: np.ndarray) -> np.ndarray:
    """8-bit pixels as ``decode_png`` gives them -> (H, W, 3) uint8, as
    PIL's ``convert("RGB")``: grey replicated, alpha dropped."""
    if arr.dtype != np.uint8:
        raise ValueError(f"to_rgb takes 8-bit pixels, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in (1, 2, 3, 4):
        raise ValueError(f"to_rgb takes (H, W[, 1-4]) pixels, got "
                         f"{arr.shape}")
    if arr.shape[-1] <= 2:
        return np.repeat(arr[..., :1], 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


def _filtered(pix: np.ndarray, bpp: int) -> np.ndarray:
    """(rows, stride) -> (5, rows, stride) int16: each row under each of
    the five filter types (None, Sub, Up, Average, Paeth)."""
    x = pix.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (0, a, b, (a + b) >> 1, paeth)
    return np.stack([(x - p) & 0xFF for p in preds])


def encode_png(arr: np.ndarray,
               filter: Union[None, int, Sequence[int]] = None,
               level: int = 6) -> bytes:
    """(H, W) uint8 or uint16 grey, or (H, W, 2 | 3 | 4) uint8 grey +
    alpha, RGB or RGBA -> PNG bytes.

    ``filter``: None picks each row's type by the least sum of absolute
    filtered bytes (libpng's rule); an int 0-4 forces that type on every
    row; a sequence gives each row's type. ``level`` is zlib's."""
    if arr.ndim == 2 and arr.dtype in (np.uint8, np.uint16):
        color, channels = 0, 1
    elif arr.ndim == 3 and arr.shape[-1] in (2, 3, 4) and \
            arr.dtype == np.uint8:
        channels = arr.shape[-1]
        color = {2: 4, 3: 2, 4: 6}[channels]
    else:
        raise ValueError(f"encode_png writes (H, W) uint8/uint16 or "
                         f"(H, W, 2-4) uint8, got {arr.shape} {arr.dtype}")
    height, width = arr.shape[:2]
    depth = 16 if arr.dtype == np.uint16 else 8
    bpp = channels * depth // 8
    pix = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr)
    pix = pix.view(np.uint8).reshape(height, width * bpp)
    options = _filtered(pix, bpp)
    if filter is None:
        signed = np.where(options > 127, 256 - options, options)
        types = signed.sum(axis=2, dtype=np.int64).argmin(axis=0)
    else:
        types = np.broadcast_to(np.asarray(filter, np.int64), (height,))
        if types.size and (types.min() < 0 or types.max() > 4):
            raise ValueError(f"PNG filter types are 0-4, got {filter}")
    rows = options[types, np.arange(height)].astype(np.uint8)
    body = np.concatenate([types.astype(np.uint8)[:, None], rows], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(body.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray, **kwargs) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(arr, **kwargs))


def pil_image(what: str):
    """PIL.Image, or an ImportError that says what needs it."""
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError(
            f"{what} needs PIL, which is not installed here; this package "
            "decodes PNG files itself (data.png), other image formats need "
            "PIL") from err
    return Image


def decode_image(data: bytes, native: bool = False) -> np.ndarray:
    """Image file bytes -> (H, W, 3) uint8 RGB: a PNG through
    ``decode_png`` and ``to_rgb``; any other format through PIL's
    ``convert("RGB")``, PIL imported only then."""
    if is_png(data):
        return to_rgb(decode_png(data, native))
    Image = pil_image("decoding an image that is not a PNG")
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


def read_image(path: str, native: bool = False) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read(), native)


def read_png(path: str, native: bool = False) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), native)
