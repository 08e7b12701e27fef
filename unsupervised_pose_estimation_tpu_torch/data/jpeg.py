"""A baseline JPEG encoder in numpy, for the colour-mapped disparity images
of ``cli.test_simple``.

Pillow's defaults: YCbCr (JFIF), chroma subsampled 4:2:0, the quality-75
scalings of the standard quantisation tables (JPEG Annex K.1, K.2) and the
standard Huffman tables (K.3-K.6). The bytes are not Pillow's (the DCT here
is float64, libjpeg's an integer one) but any JPEG decoder reads them.
Every stage is vectorised over the blocks, the entropy coding included.
"""

from __future__ import annotations

import struct

import numpy as np

# Quality 75 quantisation tables in zigzag order: the Annex K tables
# scaled by libjpeg's rule, (t * 50 + 50) // 100 clipped to 1..255.
Q_LUMA = [8, 6, 6, 7, 6, 5, 8, 7, 7, 7, 9, 9, 8, 10, 12, 20, 13, 12, 11, 11,
          12, 25, 18, 19, 15, 20, 29, 26, 31, 30, 29, 26, 28, 28, 32, 36,
          46, 39, 32, 34, 44, 35, 28, 28, 40, 55, 41, 44, 48, 49, 52, 52,
          52, 31, 39, 57, 61, 56, 50, 60, 46, 51, 52, 50]
Q_CHROMA = [9, 9, 9, 12, 11, 12, 24, 13, 13, 24] + [50, 33, 28, 33] + \
    [50] * 50

# Standard Huffman tables: (code counts by length 1-16, symbols).
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])


def _zigzag() -> np.ndarray:
    """Natural (row * 8 + col) index of each zigzag position."""
    order = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda p: (p[0] + p[1],
                                  p[0] if (p[0] + p[1]) % 2 else p[1]))
    return np.array([r * 8 + c for r, c in order])


ZIGZAG = _zigzag()
# orthonormal 8-point DCT-II matrix
_DCT = np.array([[(np.sqrt(0.125) if u == 0 else 0.5)
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def _codes(table):
    """(counts, symbols) -> (code, length) arrays indexed by symbol."""
    counts, symbols = table
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n_bits, n in enumerate(counts, start=1):
        for _ in range(n):
            code[symbols[k]], length[symbols[k]] = c, n_bits
            c += 1
            k += 1
        c <<= 1
    return code, length


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2)


def _quantised(blocks: np.ndarray, q_zigzag) -> np.ndarray:
    """(..., 8, 8) level-shifted samples -> (..., 64) zigzag int coeffs."""
    coef = _DCT @ blocks @ _DCT.T
    q = np.empty(64)
    q[ZIGZAG] = q_zigzag
    flat = coef.reshape(coef.shape[:-2] + (64,)) / q
    return np.round(flat).astype(np.int64)[..., ZIGZAG]


def _size(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (JPEG's magnitude category)."""
    a = np.abs(v)
    out = np.zeros(a.shape, np.int64)
    while np.any(a >> out):
        out += (a >> out) > 0
    return out


def _extra(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The category's extra bits: v, or v - 1 in ``size`` bits if v < 0."""
    return np.where(v < 0, v + (1 << size) - 1, v)


def _scan(coeffs: np.ndarray, comp: np.ndarray) -> bytes:
    """Entropy-code blocks (N, 64) in scan order, ``comp`` each block's
    component (0 luma, 1 and 2 chroma) -> the scan's stuffed bytes."""
    n = len(coeffs)
    dc_code, dc_len, ac_code, ac_len = [np.stack(t) for t in zip(*[
        _codes(DC_LUMA) + _codes(AC_LUMA),
        _codes(DC_CHROMA) + _codes(AC_CHROMA),
        _codes(DC_CHROMA) + _codes(AC_CHROMA)])]
    # DC: the difference from the previous block of the same component
    dc = coeffs[:, 0]
    diff = np.empty(n, np.int64)
    for c in range(3):
        sel = np.flatnonzero(comp == c)
        diff[sel] = np.diff(dc[sel], prepend=0)
    size = _size(diff)
    events = [(np.arange(n) * 65, dc_code[comp, size], dc_len[comp, size],
               _extra(diff, size), size)]
    # AC: each nonzero coefficient after its run of zeros, 16-zero runs
    # as ZRL (0xF0), then EOB (0x00) unless the block ends nonzero
    blk, pos = np.nonzero(coeffs[:, 1:])
    pos = pos + 1
    first = np.r_[True, blk[1:] != blk[:-1]] if len(blk) else blk == 0
    prev = np.where(first, 0, np.r_[0, pos[:-1]])
    run = pos - prev - 1
    v = coeffs[blk, pos]
    size = _size(v)
    sym = (run % 16) * 16 + size
    c = comp[blk]
    events.append((blk * 65 + pos, ac_code[c, sym], ac_len[c, sym],
                   _extra(v, size), size))
    zrl = run // 16
    if zrl.any():
        at = np.repeat(np.arange(len(blk)), zrl)
        # placed just before their coefficient, in order
        k = np.arange(len(at)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
        key = (blk[at] * 65 + pos[at]) - 0.5 + k / (zrl[at] + 1.0) * 0.5
        events.append((key, ac_code[c[at], 0xF0], ac_len[c[at], 0xF0],
                       np.zeros(len(at), np.int64),
                       np.zeros(len(at), np.int64)))
    last = np.zeros(n, np.int64)
    np.maximum.at(last, blk, pos)
    eob = np.flatnonzero(last < 63)
    events.append((eob * 65 + 64, ac_code[comp[eob], 0], ac_len[comp[eob], 0],
                   np.zeros(len(eob), np.int64),
                   np.zeros(len(eob), np.int64)))
    key, code, clen, extra, elen = [np.concatenate(x) for x in zip(*events)]
    order = np.argsort(key, kind="stable")
    value = (code[order] << elen[order]) | extra[order]
    length = clen[order] + elen[order]
    # pack the bits MSB first, pad the last byte with ones
    total = int(length.sum())
    owner = np.repeat(np.arange(len(length)), length)
    offset = np.arange(total) - np.repeat(np.cumsum(length) - length, length)
    bits = (value[owner] >> (length[owner] - 1 - offset)) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)])
    data = np.packbits(bits.astype(np.uint8))
    # byte stuffing: a 0x00 after every 0xFF
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def encode_jpeg(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> baseline JFIF JPEG bytes (quality 75, 4:2:0,
    standard Huffman tables)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, got "
                         f"{rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    # edge-replicate to whole 16x16 MCUs
    ph, pw = -h % 16, -w % 16
    x = np.pad(rgb, ((0, ph), (0, pw), (0, 0)), mode="edge").astype(
        np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128

    def sub(p):  # 2x2 mean
        return p.reshape(p.shape[0] // 2, 2, p.shape[1] // 2, 2).mean(
            axis=(1, 3))

    yb = _quantised(_blocks(y - 128), Q_LUMA)  # (H/8, W/8, 64)
    cbb = _quantised(_blocks(sub(cb) - 128), Q_CHROMA)
    crb = _quantised(_blocks(sub(cr) - 128), Q_CHROMA)
    my, mx = yb.shape[0] // 2, yb.shape[1] // 2
    # MCU: Y00 Y01 Y10 Y11 Cb Cr
    ymcu = yb.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        my, mx, 4, 64)
    mcu = np.concatenate([ymcu, cbb[:, :, None], crb[:, :, None]], axis=2)
    coeffs = mcu.reshape(-1, 64)
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    scan = _scan(coeffs, comp)

    def segment(marker: int, payload: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    def dht(cls_id: int, table) -> bytes:
        counts, symbols = table
        return bytes([cls_id]) + bytes(counts) + bytes(symbols)

    return b"".join([
        b"\xff\xd8",
        segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        segment(0xDB, bytes([0]) + bytes(Q_LUMA)),
        segment(0xDB, bytes([1]) + bytes(Q_CHROMA)),
        segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])),
        segment(0xC4, dht(0x00, DC_LUMA) + dht(0x10, AC_LUMA)
                + dht(0x01, DC_CHROMA) + dht(0x11, AC_CHROMA)),
        segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
        scan,
        b"\xff\xd9",
    ])


def write_jpeg(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb))
