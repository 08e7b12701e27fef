"""A TIFF reader in numpy, in place of PIL's TIFF plugin, for the
scene_points depth files of the lung and SCARED layouts.

``decode_tiff`` reads the layouts PIL reads for such a file: byte order II
or MM; one sample of float32, uint8, uint16 or int32, or 8-bit RGB or RGBA
(chunky); strips or tiles; compression none, deflate, LZW or PackBits;
predictor 1, or 2 (horizontal differencing) on integer samples, with LZW
and deflate (the others ignore the tag, as PIL does). Compressed MM files
of 32-bit samples come back byte-swapped, as PIL reads them. Any other
layout raises a ``ValueError`` that names it, among them a 3-sample
float32 file, which PIL cannot open either. The LZW decoder has two routes
with the same bytes: numpy (a Python loop over the codes), and the native
host routine of ``csrc/image_host.cpp`` (``native=True``), which entry
points on a CUDA device take (``ops.kernels._lib.native_route``).
``read_scene_points`` is the reader of the datasets: channel 0, the top
1024 rows, float32, as the reference package reads them through PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# PIL's limit, as data.png's
MAX_PIXELS = 2 * 89478485
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "deflate", 32946: "deflate",
                 32773: "PackBits"}
# (samples, bits, sample format) -> numpy dtype read
_LAYOUTS = {(1, 32, 3): "f4", (1, 8, 1): "u1", (1, 16, 1): "u2",
            (1, 32, 2): "i4", (3, 8, 1): "u1", (4, 8, 1): "u1"}
# field type -> (struct code, bytes)
_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 8: ("h", 2),
          9: ("i", 4)}


def is_tiff(data: bytes) -> bool:
    return data[:4] in (b"II*\x00", b"MM\x00*")


def _tags(data: bytes):
    """The first IFD's tags -> ({tag: tuple of values}, byte order)."""
    if not is_tiff(data):
        if data[:4] in (b"II+\x00", b"MM\x00+"):
            raise ValueError("BigTIFF is not read here")
        raise ValueError("not a TIFF file (bad header)")
    order = "<" if data[:2] == b"II" else ">"
    ifd, = struct.unpack(order + "I", data[4:8])
    if ifd + 2 > len(data):
        raise ValueError("truncated TIFF: no IFD")
    n, = struct.unpack(order + "H", data[ifd:ifd + 2])
    tags = {}
    for k in range(n):
        at = ifd + 2 + 12 * k
        if at + 12 > len(data):
            raise ValueError("truncated TIFF IFD")
        tag, kind, count = struct.unpack(order + "HHI", data[at:at + 8])
        if kind not in _TYPES:
            continue    # ASCII, rationals: nothing the reader needs
        code, size = _TYPES[kind]
        where = at + 8
        if count * size > 4:
            where, = struct.unpack(order + "I", data[at + 8:at + 12])
        end = where + count * size
        if end > len(data):
            raise ValueError(f"truncated TIFF tag {tag}")
        tags[tag] = struct.unpack(order + code * count, data[where:end])
    return tags, order


def lzw_numpy(data: bytes, cap: int) -> bytes:
    """TIFF LZW (codes MSB first, 9 to 12 bits, the width growing one code
    early) -> at most ``cap`` bytes. Raises on a code not yet defined."""
    raw = np.zeros(len(data) + 4, np.uint32)
    raw[:len(data)] = np.frombuffer(data, np.uint8)
    win = ((raw[:-3] << 24) | (raw[1:-2] << 16) | (raw[2:-1] << 8)
           | raw[3:]).tolist()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    nbits, pos, width, prev = len(data) * 8, 0, 9, None
    while pos + width <= nbits and len(out) < cap:
        code = (win[pos >> 3] >> (32 - (pos & 7) - width)) & \
            ((1 << width) - 1)
        pos += width
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if code < len(table) and code not in (256, 257):
            entry = table[code]
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
        else:
            raise ValueError(f"corrupt TIFF LZW data (code {code})")
        if prev is not None and len(table) < 4096:
            table.append(prev + entry[:1])
        out += entry
        prev = entry
        if len(table) + 1 >= 1 << width and width < 12:
            width += 1
    return bytes(out[:cap])


def lzw_native(data: bytes, cap: int) -> bytes:
    """``lzw_numpy`` through the native host routine."""
    from ..ops.kernels import _lib

    src = np.frombuffer(data, np.uint8)
    if not src.size:
        return b""
    out = np.empty(cap, np.uint8)
    written = np.zeros(1, np.int64)
    code = _lib.call_host("tiff_lzw", "upe_tiff_lzw", src.ctypes.data,
                          src.size, out.ctypes.data, cap,
                          written.ctypes.data)
    if code != 0:
        raise ValueError("corrupt TIFF LZW data (a code not yet defined)")
    return out[:int(written[0])].tobytes()


def unpackbits_tiff(data: bytes, cap: int) -> bytes:
    """PackBits -> at most ``cap`` bytes."""
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < cap:
        n = data[i]
        i += 1
        if n < 128:
            out += data[i:i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i:i + 1] * (257 - n)
            i += 1
    return bytes(out[:cap])


def _inflate(data: bytes, cap: int) -> bytes:
    try:
        return zlib.decompressobj().decompress(data, cap)
    except zlib.error as err:
        raise ValueError(f"TIFF deflate data does not inflate: {err}") \
            from err


def decode_tiff(data: bytes, native: bool = False) -> np.ndarray:
    """TIFF bytes -> (H, W) samples, or (H, W, S) for RGB and RGBA: float32,
    uint8, uint16 or int32. ``native`` takes the native LZW decoder."""
    tags, order = _tags(data)

    def one(tag, default=None):
        if tag not in tags:
            if default is None:
                raise ValueError(f"TIFF has no tag {tag}")
            return default
        return tags[tag][0]

    width, height = one(256), one(257)
    spp = one(277, 1)
    bits = tags.get(258, (1,) * spp)
    fmt = tags.get(339, (1,) * spp)
    if len(set(bits)) != 1 or len(set(fmt)) != 1:
        raise ValueError(f"TIFF with mixed samples (bits {bits}, formats "
                         f"{fmt}) is not read here")
    layout = (spp, bits[0], fmt[0])
    if layout not in _LAYOUTS:
        raise ValueError(f"TIFF of {spp} sample(s) of {bits[0]} bits, "
                         f"sample format {fmt[0]} is not read here "
                         "(1 sample of float32, uint8, uint16 or int32, or "
                         "8-bit RGB or RGBA are)")
    photometric = one(262, -1)
    if photometric != (1 if spp == 1 else 2):
        raise ValueError(f"TIFF photometric interpretation {photometric} "
                         f"with {spp} sample(s) is not read here")
    if spp > 1 and one(284, 1) != 1:
        raise ValueError("TIFF with separate sample planes (planar "
                         "configuration 2) is not read here")
    compression = one(259, 1)
    if compression not in _COMPRESSIONS:
        raise ValueError(f"TIFF compression {compression} is not read here "
                         "(none, deflate, LZW and PackBits are)")
    # libtiff applies the predictor with LZW and deflate only; PIL's own raw
    # decoder and libtiff's PackBits ignore the tag
    predictor = one(317, 1) if compression in (5, 8, 32946) else 1
    if predictor not in (1, 2) or (predictor == 2 and fmt[0] == 3):
        raise ValueError(f"TIFF predictor {predictor} on sample format "
                         f"{fmt[0]} is not read here (1, and 2 on integer "
                         "samples are)")
    if one(266, 1) != 1:
        raise ValueError("TIFF fill order 2 is not read here")
    if not 0 < width * height <= MAX_PIXELS:
        raise ValueError(f"TIFF of {width}x{height} pixels (at most "
                         f"{MAX_PIXELS} are read)")
    dtype = np.dtype(order + _LAYOUTS[layout])
    pixel = spp * dtype.itemsize
    if 322 in tags:
        tw, th = one(322), one(323)
        offsets, counts = tags.get(324), tags.get(325)
        across, down = -(-width // tw), -(-height // th)
    else:
        tw, th = width, min(one(278, height), height)
        offsets, counts = tags.get(273), tags.get(279)
        across, down = 1, -(-height // th)
    if offsets is None or counts is None or \
            len(offsets) != len(counts) or len(offsets) < across * down:
        raise ValueError("TIFF strip or tile offsets are missing")
    lzw = lzw_native if native else lzw_numpy
    decompress = {1: lambda b, cap: b[:cap], 5: lzw, 8: _inflate,
                  32946: _inflate, 32773: unpackbits_tiff}[compression]
    out = np.empty((down * th, across * tw, spp), dtype)
    kind = "tile" if 322 in tags else "strip"
    for k in range(across * down):
        r, c = divmod(k, across)
        rows = th if 322 in tags else min(th, height - r * th)
        need = rows * tw * pixel
        chunk = data[offsets[k]:offsets[k] + counts[k]]
        raw = decompress(chunk, need)
        if len(chunk) != counts[k] or len(raw) < need:
            raise ValueError(f"truncated TIFF {kind} {k}")
        block = np.frombuffer(raw, dtype, need // dtype.itemsize).reshape(
            rows, tw, spp)
        if predictor == 2:
            # horizontal differencing: running sums along each row, in the
            # samples' own width
            block = np.cumsum(block.astype(dtype.newbyteorder("=")), axis=1,
                              dtype=dtype.newbyteorder("="))
        out[r * th:r * th + rows, c * tw:(c + 1) * tw] = block
    out = out[:height, :width].astype(dtype.newbyteorder("="))
    if order == ">" and compression != 1 and dtype.itemsize == 4:
        # PIL (12.1.0) reads these byte-swapped: libtiff hands it native
        # samples, which it swaps again as big-endian ones
        out = out.byteswap()
    return out[..., 0] if spp == 1 else out


def read_tiff(path: str, native: bool = False) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_tiff(f.read(), native)


def read_scene_points(path: str, native: bool = False) -> np.ndarray:
    """A scene_points TIFF -> its depth plane: channel 0, the top 1024
    rows, float32."""
    arr = read_tiff(path, native).astype(np.float32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr[:1024, :]
