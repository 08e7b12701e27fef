"""A JPEG codec in numpy, in place of PIL's JPEG plugin (libjpeg-turbo).

``encode_jpeg`` writes the bytes of Pillow's ``Image.save(f, "JPEG")`` at
its defaults: baseline JFIF, quality 75, chroma 4:2:0 and the standard
Huffman tables (JPEG Annex K), through libjpeg-turbo's fixed-point RGB to
YCbCr (``jccolor.c``), its downsampling with the alternating bias and the
right and bottom edges replicated (``jcsample.c``, ``jcprepct.c``), its
integer forward DCT (``jfdctint.c``) and its rounding quantisation
(``jcdctmgr.c``).

``decode_jpeg`` gives the pixels of ``Image.open(f)``, as libjpeg-turbo
decodes at its defaults: 8-bit Huffman files, baseline (sequential) and
progressive, grey or three components (YCbCr, or RGB by the Adobe marker
or the component ids) with luma sampling 1x1, 2x1, 2x2 or 4x1 over 1x1
chroma, restart intervals, any size. The stages are libjpeg-turbo's: the
integer inverse DCT (``jidctint.c``), fancy upsampling for 2x1 and 2x2 and
replication for 4x1 (``jdsample.c``), and the fixed-point YCbCr to RGB
(``jdcolor.c``). It refuses, with a ``ValueError`` that names the case,
arithmetic coding, 12-bit and lossless files, four components (CMYK,
YCCK), other sampling factors, a truncated or corrupt scan, and a
progressive file whose scans leave some coefficient bits unknown (where
libjpeg-turbo smooths the blocks). EXIF orientation is not applied, as
``Image.open`` does not.

The entropy decoding of each scan and the pixel stage (inverse DCT,
upsampling, colour) have two routes with the same bytes: numpy (with a
Python loop for the entropy decoding), and the native host routines of
``csrc/image_host.cpp`` (``native=True``), which entry points on a CUDA
device take (``ops.kernels._lib.native_route``).
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

# PIL's limit, as data.png's
MAX_PIXELS = 2 * 89478485
# luma sampling factors read (chroma 1x1); one component reads any
SAMPLINGS = ((1, 1), (2, 1), (2, 2), (4, 1))
# libjpeg's fixed-point colour constants: FIX(x) = round(x * 2^16)
_SCALEBITS = 16


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def _zigzag() -> np.ndarray:
    """Natural (row * 8 + col) index of each zigzag position."""
    order = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda p: (p[0] + p[1],
                                  p[0] if (p[0] + p[1]) % 2 else p[1]))
    return np.array([r * 8 + c for r, c in order])


ZIGZAG = _zigzag()

# jfdctint.c / jidctint.c: CONST_BITS 13, PASS1_BITS 2
_C = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, shift_even, shift_odd, axis):
    """One pass of libjpeg's jpeg_fdct_islow along ``axis`` (length 8) of
    int64 ``d``; the even outputs 0 and 4 are shifted left by
    ``shift_even`` if positive, descaled by -``shift_even`` otherwise."""
    x = [np.take(d, i, axis=axis) for i in range(8)]
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if shift_even >= 0:
        out[0] = (tmp10 + tmp11) << shift_even
        out[4] = (tmp10 - tmp11) << shift_even
    else:
        out[0] = _descale(tmp10 + tmp11, -shift_even)
        out[4] = _descale(tmp10 - tmp11, -shift_even)
    z1 = (tmp12 + tmp13) * _C["f0541"]
    out[2] = _descale(z1 + tmp13 * _C["f0765"], shift_odd)
    out[6] = _descale(z1 - tmp12 * _C["f1847"], shift_odd)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _C["f1175"]
    tmp4 = tmp4 * _C["f0298"]
    tmp5 = tmp5 * _C["f2053"]
    tmp6 = tmp6 * _C["f3072"]
    tmp7 = tmp7 * _C["f1501"]
    z1 = z1 * -_C["f0899"]
    z2 = z2 * -_C["f2562"]
    z3 = z3 * -_C["f1961"] + z5
    z4 = z4 * -_C["f0390"] + z5
    out[7] = _descale(tmp4 + z1 + z3, shift_odd)
    out[5] = _descale(tmp5 + z2 + z4, shift_odd)
    out[3] = _descale(tmp6 + z2 + z3, shift_odd)
    out[1] = _descale(tmp7 + z1 + z4, shift_odd)
    return np.stack(out, axis=axis)


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(..., 8, 8) level-shifted samples -> libjpeg's integer DCT, scaled
    up by 8 (int64)."""
    d = _fdct_1d(blocks.astype(np.int64), 2, 11, -1)    # rows
    return _fdct_1d(d, -2, 15, -2)                      # columns


def _idct_1d(x, shift, axis):
    """One pass of libjpeg's jpeg_idct_islow along ``axis``: the outputs
    descaled by ``shift`` (its shortcuts for all-zero AC terms give the same
    values)."""
    v = [np.take(x, i, axis=axis) for i in range(8)]
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * _C["f0541"]
    tmp2 = z1 - z3 * _C["f1847"]
    tmp3 = z1 + z2 * _C["f0765"]
    tmp0 = (v[0] + v[4]) << 13
    tmp1 = (v[0] - v[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = v[7], v[5], v[3], v[1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _C["f1175"]
    tmp0 = tmp0 * _C["f0298"]
    tmp1 = tmp1 * _C["f2053"]
    tmp2 = tmp2 * _C["f3072"]
    tmp3 = tmp3 * _C["f1501"]
    z1 = z1 * -_C["f0899"]
    z2 = z2 * -_C["f2562"]
    z3 = z3 * -_C["f1961"] + z5
    z4 = z4 * -_C["f0390"] + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    out = [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
           tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]
    return np.stack([_descale(o, shift) for o in out], axis=axis)


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(..., 64) coefficients in natural order and (64,) quantisation
    values -> (..., 8, 8) uint8 samples, libjpeg's jpeg_idct_islow with its
    range limit (the sum taken mod 1024, then clamped)."""
    x = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(
        coef.shape[:-1] + (8, 8))
    ws = _idct_1d(x, 11, -2)         # columns: CONST_BITS - PASS1
    out = _idct_1d(ws, 18, -1)      # rows: CONST_BITS + PASS1 + 3
    out = ((out + 512) & 1023) - 512
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# --- encoder -------------------------------------------------------------


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
    """Entropy-code blocks (N, 64) in zigzag order in scan order, ``comp``
    each block's component (0 luma, 1 and 2 chroma) -> the scan's stuffed
    bytes."""
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


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (3, H, W) int64 Y, Cb, Cr, jccolor.c's
    rgb_ycc_convert (16-bit fixed point; Cb and Cr round by 0.5 - 2^-16)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << (_SCALEBITS - 1)
    cbcr = (128 << _SCALEBITS) + half - 1
    y = _fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half
    cb = -_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + cbcr
    cr = _fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + cbcr
    return np.stack([y, cb, cr]) >> _SCALEBITS


def _downsample(plane: np.ndarray, fh: int, fv: int, cols: int,
                rows: int) -> np.ndarray:
    """A full-size plane -> ``rows`` x ``cols`` samples, each the mean of
    fv x fh input samples as jcsample.c rounds it (2x2: bias 1, 2, 1, ...
    along a row; 2x1: 0, 1, 0, ...; otherwise half the count), the input
    widened to cols * fh by its last column, heightened to a multiple of fv
    by its last row, and the output heightened to ``rows`` by its last
    row."""
    h, w = plane.shape
    ph = -(-h // fv) * fv
    x = np.pad(plane, ((0, ph - h), (0, cols * fh - w)), mode="edge")
    s = x.reshape(ph // fv, fv, cols, fh).sum(axis=(1, 3))
    if (fh, fv) == (2, 2):
        s = (s + 1 + (np.arange(cols) & 1)) >> 2
    elif (fh, fv) == (2, 1):
        s = (s + (np.arange(cols) & 1)) >> 1
    elif (fh, fv) != (1, 1):
        s = (s + fh * fv // 2) // (fh * fv)
    return np.pad(s, ((0, rows - len(s)), (0, 0)), mode="edge")


class _Component:
    """A component's geometry in a frame of ``width`` x ``height`` whose
    largest sampling factors are ``hmax``, ``vmax``: its sample size
    (downsampled), its blocks, and the block grid of the interleaved MCUs
    (``mcux`` x ``mcuy`` MCUs of h x v blocks)."""

    def __init__(self, h, v, width, height, hmax, vmax):
        self.h, self.v = h, v
        self.width = -(-width * h // hmax)
        self.height = -(-height * v // vmax)
        self.bw, self.bh = -(-self.width // 8), -(-self.height // 8)
        mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
        self.cols, self.rows = mcux * h, mcuy * v


def encode_jpeg(rgb: np.ndarray, sampling=(2, 2)) -> bytes:
    """(H, W, 3) uint8 RGB -> the bytes of Pillow's ``save(f, "JPEG")`` at
    its defaults (baseline JFIF, quality 75, the standard Huffman tables).
    ``sampling``: the luma's (h, v) sampling factors over 1x1 chroma; the
    default (2, 2) is Pillow's 4:2:0, (2, 1) and (1, 1) its 4:2:2 and
    4:4:4."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3 or \
            0 in rgb.shape:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, got "
                         f"{rgb.shape} {rgb.dtype}")
    if tuple(sampling) not in SAMPLINGS:
        raise ValueError(f"encode_jpeg writes luma sampling {SAMPLINGS}, "
                         f"got {sampling}")
    h, w = rgb.shape[:2]
    hmax, vmax = sampling
    ycc = rgb_to_ycc(rgb)
    qnat = []
    for q in (Q_LUMA, Q_CHROMA):
        t = np.empty(64, np.int64)
        t[ZIGZAG] = q
        qnat.append(t << 3)
    blocks = []
    for ci in range(3):
        fh, fv = (1, 1) if ci == 0 else (hmax, vmax)
        comp = _Component(*((hmax, vmax) if ci == 0 else (1, 1)), w, h,
                          hmax, vmax)
        plane = _downsample(ycc[ci], fh, fv, comp.bw * 8, comp.rows * 8)
        plane = plane[:comp.bh * 8]
        coef = fdct_islow(plane.reshape(comp.bh, 8, comp.bw, 8).swapaxes(
            1, 2) - 128).reshape(comp.bh, comp.bw, 64)
        q = qnat[min(ci, 1)]
        quant = np.sign(coef) * ((np.abs(coef) + (q >> 1)) // q)
        # dummy blocks past the component's edge: zero AC, and the DC of
        # the block before them in the MCU (jccoefct.c)
        grid = np.zeros((comp.rows, comp.cols, 64), np.int64)
        grid[:comp.bh, :comp.bw] = quant[..., ZIGZAG]
        grid[:comp.bh, comp.bw:, 0] = grid[:comp.bh, comp.bw - 1:comp.bw, 0]
        for r in range(comp.bh, comp.rows):
            grid[r, :, 0] = grid[r - 1, (np.arange(comp.cols) // comp.h + 1)
                                 * comp.h - 1, 0]
        mcuy, mcux = comp.rows // comp.v, comp.cols // comp.h
        blocks.append(grid.reshape(mcuy, comp.v, mcux, comp.h, 64).transpose(
            0, 2, 1, 3, 4).reshape(mcuy, mcux, comp.v * comp.h, 64))
    coeffs = np.concatenate(blocks, axis=2).reshape(-1, 64)
    per_mcu = [0] * (hmax * vmax) + [1, 2]
    comp_of = np.tile(per_mcu, len(coeffs) // len(per_mcu))
    scan = _scan(coeffs, comp_of)

    def segment(marker: int, payload: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    def dht(cls_id: int, table) -> bytes:
        counts, symbols = table
        return segment(0xC4, bytes([cls_id]) + bytes(counts) + bytes(symbols))

    luma = hmax * 16 + vmax
    return b"".join([
        b"\xff\xd8",
        segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        segment(0xDB, bytes([0]) + bytes(Q_LUMA)),
        segment(0xDB, bytes([1]) + bytes(Q_CHROMA)),
        segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                + bytes([1, luma, 0, 2, 0x11, 1, 3, 0x11, 1])),
        dht(0x00, DC_LUMA), dht(0x10, AC_LUMA),
        dht(0x01, DC_CHROMA), dht(0x11, AC_CHROMA),
        segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
        scan,
        b"\xff\xd9",
    ])


# --- decoder -------------------------------------------------------------


def is_jpeg(data: bytes) -> bool:
    return data[:3] == b"\xff\xd8\xff"


def huffman_lut(counts, symbols, dc: bool) -> np.ndarray:
    """A Huffman table -> its 16-bit lookahead table: (65536,) uint16,
    entry ``code << (16 - length)`` (and the entries below the next code)
    holding ``length << 8 | symbol``; 0 where no code starts. Raises on a
    table libjpeg refuses (an overfull code, a DC category above 15)."""
    lut = np.zeros(1 << 16, np.uint16)
    code, k = 0, 0
    for n_bits, n in enumerate(counts, start=1):
        for _ in range(n):
            if code >= 1 << n_bits or k >= len(symbols):
                raise ValueError("JPEG has a malformed Huffman table")
            if dc and symbols[k] > 15:
                raise ValueError(f"JPEG DC Huffman symbol {symbols[k]} "
                                 "(above 15)")
            lo = code << (16 - n_bits)
            lut[lo:lo + (1 << (16 - n_bits))] = n_bits << 8 | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut


class Scan:
    """One scan's parameters: ``comps`` (indices into the frame's
    components), spectral band ``ss``..``se``, successive approximation
    ``ah``, ``al``, the restart interval in MCUs (0: none), and the
    entropy-coded data: ``data`` (the segments between restart markers,
    unstuffed, one after the other) and ``seg`` (their byte offsets, one
    more than the segments)."""

    def __init__(self, comps, tables, ss, se, ah, al, restart, data, seg):
        self.comps, self.tables = comps, tables
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.restart, self.data, self.seg = restart, data, seg


def _entropy_data(data: bytes, pos: int):
    """The entropy-coded bytes from ``pos`` up to the next marker that is
    not a restart marker -> (unstuffed segments joined, their offsets,
    the position of that marker, or len(data) if the file ends)."""
    arr = np.frombuffer(data, np.uint8)[pos:]
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    stops = ff[(nxt != 0) & ((nxt < 0xD0) | (nxt > 0xD7))]
    end = int(stops[0]) if len(stops) else len(arr)
    inside = ff < end
    ff, nxt = ff[inside], nxt[inside]
    rst = ff[nxt != 0]
    keep = np.ones(end, bool)
    keep[ff[nxt == 0] + 1] = False          # the stuffed zero after 0xFF
    keep[rst] = keep[rst + 1] = False       # the restart markers
    starts = np.r_[0, rst + 2]
    seg = np.cumsum(np.r_[0, [keep[a:b].sum() for a, b in
                              zip(starts, np.r_[rst, end])]])
    return arr[:end][keep], seg.astype(np.int64), pos + end


def _block_order(frame, scan):
    """-> (component slot in the scan, block index in the component's
    grid) of each block in decoding order, and the blocks per MCU."""
    comps = [frame.comps[c] for c in scan.comps]
    if len(comps) == 1:
        c = comps[0]
        r, q = np.mgrid[0:c.bh, 0:c.bw]
        return (np.zeros(r.size, np.int64),
                (r * c.cols + q).ravel(), 1)
    mcuy, mcux = frame.mcuy, frame.mcux
    slots, idx = [], []
    for k, c in enumerate(comps):
        my, mx, r, q = np.meshgrid(np.arange(mcuy), np.arange(mcux),
                                   np.arange(c.v), np.arange(c.h),
                                   indexing="ij")
        slots.append(np.full((mcuy, mcux, c.v * c.h), k))
        idx.append(((my * c.v + r) * c.cols + mx * c.h + q).reshape(
            mcuy, mcux, -1))
    per_mcu = sum(c.v * c.h for c in comps)
    return (np.concatenate(slots, -1).ravel(),
            np.concatenate(idx, -1).ravel(), per_mcu)


_ZZ = ZIGZAG.tolist()


def _wrap16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


def entropy_numpy(frame, scan, coefs, luts) -> int:
    """Decode ``scan`` into ``coefs`` (per component of the frame, (rows *
    cols, 64) int16, natural order) with the lookahead tables ``luts``
    ((8, 65536): DC tables 0-3, then AC tables 0-3) -> 0, or 1 if a
    segment's data runs out, 2 on an undefined code, 3 on a coefficient
    past the band, 4 if the restart segments do not match the MCUs."""
    slots, idx, per_mcu = _block_order(frame, scan)
    n_mcu = len(idx) // per_mcu
    restart = scan.restart or n_mcu
    n_seg = -(-n_mcu // restart)
    if len(scan.seg) - 1 != n_seg:
        return 4
    comp_ids = scan.comps
    store = [coefs[c].reshape(-1).tolist() for c in comp_ids]
    dc_luts = [luts[scan.tables[k][0]].tolist() for k in range(len(comp_ids))]
    ac_luts = [luts[4 + scan.tables[k][1]].tolist()
               for k in range(len(comp_ids))]
    slots, idx = slots.tolist(), idx.tolist()
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    p1, m1 = 1 << al, -(1 << al)
    zz = _ZZ
    for s_i in range(n_seg):
        a, b = int(scan.seg[s_i]), int(scan.seg[s_i + 1])
        raw = np.zeros(b - a + 8, np.uint32)
        raw[:b - a] = scan.data[a:b]
        win = ((raw[:-3] << 24) | (raw[1:-2] << 16) | (raw[2:-1] << 8)
               | raw[3:]).tolist()
        nbits = (b - a) * 8
        p = 0
        pred = [0] * len(comp_ids)
        eobrun = 0
        try:
            for blk in range(s_i * restart * per_mcu,
                             min(n_mcu, (s_i + 1) * restart) * per_mcu):
                slot = slots[blk]
                co = store[slot]
                base = idx[blk] * 64
                if ss == 0:
                    if ah == 0:
                        e = dc_luts[slot][(win[p >> 3] >> (16 - (p & 7)))
                                          & 0xFFFF]
                        if not e:
                            return 2
                        p += e >> 8
                        s = e & 255
                        v = 0
                        if s:
                            v = (win[p >> 3] >> (32 - (p & 7) - s)) & \
                                ((1 << s) - 1)
                            p += s
                            if v < 1 << (s - 1):
                                v += 1 - (1 << s)
                        pred[slot] += v
                        co[base] = _wrap16(pred[slot] << al)
                    else:
                        if (win[p >> 3] >> (31 - (p & 7))) & 1:
                            co[base] = _wrap16(co[base] | p1)
                        p += 1
                    if se == 0:
                        if (blk + 1) % per_mcu == 0 and p > nbits:
                            return 1
                        continue
                # AC band ss..se (from 1 in a sequential scan)
                k = max(ss, 1)
                lut = ac_luts[slot]
                if ah == 0:
                    if eobrun:
                        eobrun -= 1
                    else:
                        while k <= se:
                            e = lut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                            if not e:
                                return 2
                            p += e >> 8
                            r, s = (e >> 4) & 15, e & 15
                            if s:
                                k += r
                                if k > se:
                                    return 3
                                v = (win[p >> 3] >> (32 - (p & 7) - s)) & \
                                    ((1 << s) - 1)
                                p += s
                                if v < 1 << (s - 1):
                                    v += 1 - (1 << s)
                                co[base + zz[k]] = _wrap16(v << al)
                                k += 1
                            elif r == 15:
                                k += 16
                            else:
                                if ss:   # EOBr: 2^r blocks and r more bits
                                    eobrun = 1 << r
                                    if r:
                                        eobrun += (win[p >> 3] >> (
                                            32 - (p & 7) - r)) & ((1 << r) - 1)
                                        p += r
                                    eobrun -= 1
                                break
                else:
                    if not eobrun:
                        while k <= se:
                            e = lut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                            if not e:
                                return 2
                            p += e >> 8
                            r, s = (e >> 4) & 15, e & 15
                            if s:
                                if s != 1:
                                    return 2
                                s = p1 if (win[p >> 3] >> (31 - (p & 7))) \
                                    & 1 else m1
                                p += 1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += (win[p >> 3] >> (
                                        32 - (p & 7) - r)) & ((1 << r) - 1)
                                    p += r
                                break
                            # skip r zero-history coefficients, correcting
                            # the nonzero ones on the way
                            while k <= se:
                                at = base + zz[k]
                                c = co[at]
                                if c:
                                    if (win[p >> 3] >> (31 - (p & 7))) & 1 \
                                            and not c & p1:
                                        co[at] = _wrap16(c + (p1 if c >= 0
                                                              else m1))
                                    p += 1
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if s:
                                if k > se:
                                    return 3
                                co[base + zz[k]] = s
                            k += 1
                    if eobrun:
                        # correction bits of the band's nonzero
                        # coefficients after the end of band
                        while k <= se:
                            at = base + zz[k]
                            c = co[at]
                            if c:
                                if (win[p >> 3] >> (31 - (p & 7))) & 1 \
                                        and not c & p1:
                                    co[at] = _wrap16(c + (p1 if c >= 0
                                                          else m1))
                                p += 1
                            k += 1
                        eobrun -= 1
                if (blk + 1) % per_mcu == 0 and p > nbits:
                    return 1
        except IndexError:
            return 1
    for c, values in zip(comp_ids, store):
        coefs[c][...] = np.asarray(values, np.int16).reshape(
            coefs[c].shape)
    return 0


def entropy_native(frame, scan, coefs, luts) -> int:
    """``entropy_numpy`` through the native host routine."""
    from ..ops.kernels import _lib

    params = [len(scan.comps), scan.ss, scan.se, scan.ah, scan.al,
              frame.mcux, frame.mcuy, scan.restart, len(scan.seg) - 1]
    for k, c in enumerate(scan.comps):
        comp = frame.comps[c]
        params += [comp.h, comp.v, comp.bw, comp.bh, comp.cols,
                   scan.tables[k][0], scan.tables[k][1]]
    ptrs = np.array([coefs[c].ctypes.data for c in scan.comps], np.uint64)
    params = np.asarray(params, np.int32)
    data = np.ascontiguousarray(scan.data, np.uint8)
    seg = np.ascontiguousarray(scan.seg, np.int64)
    luts = np.ascontiguousarray(luts, np.uint16)
    return _lib.call_host("jpeg_entropy", "upe_jpeg_entropy",
                          data.ctypes.data, seg.ctypes.data,
                          params.ctypes.data, ptrs.ctypes.data,
                          luts.ctypes.data)


def upsample_numpy(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component's samples (its downsampled size) -> fh x fv as many,
    jdsample.c: the triangle ("fancy") filter for 2x1 and 2x2 over a plane
    more than 2 samples wide, replication otherwise."""
    x = plane.astype(np.int32)
    w = x.shape[1]
    if (fh, fv) in ((2, 1), (2, 2)) and w > 2:
        if fv == 2:
            # column sums of 3/4 the nearer row and 1/4 the other (the top
            # and bottom rows stand in for the rows past them)
            above = np.concatenate([x[:1], x[:-1]])
            below = np.concatenate([x[1:], x[-1:]])
            x = np.stack([3 * x + above, 3 * x + below], 1).reshape(-1, w)
            bias, shift = (8, 7), 4
        else:
            bias, shift = (1, 2), 2
        left = np.concatenate([x[:, :1], x[:, :-1]], 1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
        even = (3 * x + left + bias[0]) >> shift
        odd = (3 * x + right + bias[1]) >> shift
        # the first and last columns: the edge sample alone
        if fv == 2:
            even[:, 0] = (4 * x[:, 0] + 8) >> 4
            odd[:, -1] = (4 * x[:, -1] + 7) >> 4
        else:
            even[:, 0], odd[:, -1] = x[:, 0], x[:, -1]
        return np.stack([even, odd], -1).reshape(x.shape[0], 2 * w)
    return np.repeat(np.repeat(x, fv, 0), fh, 1)


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """Y, Cb, Cr planes -> (H, W, 3) uint8, jdcolor.c's ycc_rgb_convert
    (16-bit fixed point tables)."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << (_SCALEBITS - 1)
    cr_r = (_fix(1.40200) * x + half) >> _SCALEBITS
    cb_b = (_fix(1.77200) * x + half) >> _SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + half
    y = y.astype(np.int64)
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> _SCALEBITS),
                    y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def pixels_numpy(frame, coefs, quants) -> np.ndarray:
    """Coefficients -> (H, W) grey or (H, W, 3) RGB uint8: each block's
    inverse DCT, each component upsampled to the frame, the colour
    converted (YCbCr) or not (RGB)."""
    planes = []
    for comp, coef, q in zip(frame.comps, coefs, quants):
        blocks = idct_islow(coef.reshape(comp.rows, comp.cols, 64)[
            :comp.bh, :comp.bw], q)
        plane = blocks.swapaxes(1, 2).reshape(comp.bh * 8, comp.bw * 8)[
            :comp.height, :comp.width]
        up = upsample_numpy(plane, frame.hmax // comp.h,
                            frame.vmax // comp.v)
        planes.append(up[:frame.height, :frame.width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    if frame.rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return ycc_to_rgb(*planes)


def pixels_native(frame, coefs, quants) -> np.ndarray:
    """``pixels_numpy`` through the native host routine."""
    from ..ops.kernels import _lib

    n = len(frame.comps)
    out = np.empty((frame.height, frame.width) + ((3,) if n == 3 else ()),
                   np.uint8)
    params = [n, frame.width, frame.height, frame.hmax, frame.vmax,
              int(frame.rgb)]
    for comp in frame.comps:
        params += [comp.h, comp.v, comp.width, comp.height, comp.cols]
    ptrs = np.array([c.ctypes.data for c in coefs], np.uint64)
    params = np.asarray(params, np.int32)
    q = np.ascontiguousarray(np.stack(quants), np.int32)
    code = _lib.call_host("jpeg_pixels", "upe_jpeg_pixels", ptrs.ctypes.data,
                          q.ctypes.data, params.ctypes.data,
                          out.ctypes.data)
    if code != 0:
        raise ValueError(f"JPEG pixel stage failed ({code})")
    return out


class Frame:
    """The frame header: size, components (``_Component``), the largest
    sampling factors, the MCU grid, and whether the three components are
    RGB rather than YCbCr."""

    def __init__(self, width, height, sampling, rgb):
        self.width, self.height = width, height
        self.hmax = max(h for h, _ in sampling)
        self.vmax = max(v for _, v in sampling)
        self.comps = [_Component(h, v, width, height, self.hmax, self.vmax)
                      for h, v in sampling]
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        self.rgb = rgb


_SOF_REFUSED = {0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
                0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical (SOF7)",
                0xCB: "lossless arithmetic-coded (SOF11)",
                0xCF: "lossless arithmetic-coded (SOF15)"}


def _read_frame(body, marker, app):
    precision, height, width, n = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"JPEG of {precision}-bit samples is not read "
                         "here (8-bit is)")
    if n == 4:
        raise ValueError("JPEG with four components (CMYK or YCCK) is not "
                         "read here")
    if n not in (1, 3) or len(body) < 6 + 3 * n:
        raise ValueError(f"JPEG with {n} components is not read here")
    if width == 0 or height == 0:
        raise ValueError(f"JPEG of {width}x{height} pixels (a height set "
                         "by a DNL marker is not read here)")
    if width * height > MAX_PIXELS:
        raise ValueError(f"JPEG of {width}x{height} pixels (at most "
                         f"{MAX_PIXELS} are read)")
    ids, sampling, tq = [], [], []
    for k in range(n):
        cid, hv, q = body[6 + 3 * k:9 + 3 * k]
        ids.append(cid)
        sampling.append((hv >> 4, hv & 15))
        tq.append(q)
    if n == 1:
        if not (1 <= sampling[0][0] <= 4 and 1 <= sampling[0][1] <= 4):
            raise ValueError(f"JPEG sampling factors {sampling[0]}")
        sampling = [(1, 1)]
    elif sampling[1:] != [(1, 1), (1, 1)] or sampling[0] not in SAMPLINGS:
        raise ValueError(f"JPEG sampling factors {sampling} are not read "
                         f"here (luma {SAMPLINGS} over 1x1 chroma are)")
    # libjpeg-turbo's colour space of three components (jdapimin.c)
    if app.get("jfif"):
        rgb = False
    elif "adobe" in app:
        rgb = app["adobe"] == 0
    else:
        rgb = ids == [82, 71, 66]
    return Frame(width, height, sampling, rgb), ids, tq


def decode_jpeg(data: bytes, native: bool = False) -> np.ndarray:
    """JPEG bytes -> (H, W) grey or (H, W, 3) RGB uint8, the pixels of
    ``Image.open``. ``native`` takes the native entropy decoding and pixel
    stage. Raises ``ValueError`` on a malformed file or one it does not
    read (see the module's docstring)."""
    if not is_jpeg(data):
        raise ValueError("not a JPEG file (no SOI marker)")
    entropy = entropy_native if native else entropy_numpy
    pixels = pixels_native if native else pixels_numpy
    frame = ids = tq = coefs = None
    dc_tabs, ac_tabs, qtabs, app = {}, {}, {}, {}
    luts = np.zeros((8, 1 << 16), np.uint16)
    quants, coef_bits = {}, None
    restart, progressive, pos = 0, False, 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and \
                pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1                                # fill bytes
        if pos + 2 > len(data):
            if frame is not None and not progressive and coef_bits is not \
                    None and (coef_bits == 0).all():
                break                               # no EOI after the scan
            raise ValueError("truncated JPEG: no EOI marker")
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: no marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        if pos + 4 > len(data):
            raise ValueError("truncated JPEG marker")
        length, = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if length < 2 or len(body) != length - 2:
            raise ValueError(f"truncated JPEG segment 0xFF{marker:02X}")
        pos += 2 + length
        if marker == 0xE0 and body[:5] == b"JFIF\x00" and len(body) >= 14:
            app["jfif"] = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            app["adobe"] = body[11]
        elif marker == 0xDB:
            k = 0
            while k < len(body):
                pq, t = body[k] >> 4, body[k] & 15
                n = 128 if pq else 64
                if t > 3 or pq > 1 or k + 1 + n > len(body):
                    raise ValueError("JPEG has a malformed DQT segment")
                vals = np.frombuffer(body[k + 1:k + 1 + n],
                                     ">u2" if pq else np.uint8)
                nat = np.empty(64, np.int32)
                nat[ZIGZAG] = vals
                qtabs[t] = nat
                k += 1 + n
        elif marker == 0xC4:
            k = 0
            while k < len(body):
                if k + 17 > len(body):
                    raise ValueError("JPEG has a malformed DHT segment")
                tc, th = body[k] >> 4, body[k] & 15
                counts = list(body[k + 1:k + 17])
                symbols = list(body[k + 17:k + 17 + sum(counts)])
                if tc > 1 or th > 3 or len(symbols) != sum(counts):
                    raise ValueError("JPEG has a malformed DHT segment")
                luts[tc * 4 + th] = huffman_lut(counts, symbols, tc == 0)
                (ac_tabs if tc else dc_tabs)[th] = True
                k += 17 + sum(counts)
        elif marker == 0xDD:
            restart, = struct.unpack(">H", body[:2])
        elif marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("JPEG has two frame headers")
            frame, ids, tq = _read_frame(body, marker, app)
            progressive = marker == 0xC2
            coefs = [np.zeros((c.rows * c.cols, 64), np.int16)
                     for c in frame.comps]
            coef_bits = np.full((len(ids), 64), -1, np.int64)
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(
                f"JPEG {_SOF_REFUSED.get(marker, 'arithmetic-coded')} "
                f"(SOF marker 0xFF{marker:02X}) is not read here")
        elif marker == 0xCC:
            raise ValueError("JPEG arithmetic coding (DAC) is not read here")
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = body[0]
            if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
                raise ValueError("JPEG has a malformed SOS segment")
            comps, tables = [], []
            for k in range(ns):
                cid, tt = body[1 + 2 * k:3 + 2 * k]
                if cid not in ids:
                    raise ValueError(f"JPEG scan of component {cid} not in "
                                     "its frame")
                comps.append(ids.index(cid))
                tables.append((tt >> 4, tt & 15))
            ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = ahl >> 4, ahl & 15
            if progressive:
                bad = (ss > se or se > 63 or al > 13 or (ss == 0) != (se == 0)
                       or (ss and ns != 1))
            else:
                bad = (ss, se, ah, al) != (0, 63, 0, 0)
            if bad:
                raise ValueError(f"JPEG scan band {ss}..{se}, bits {ah}/{al} "
                                 "is not valid")
            if ns > 1 and sum(frame.comps[c].h * frame.comps[c].v
                              for c in comps) > 10:
                raise ValueError("JPEG MCU of more than 10 blocks")
            for c, (td, ta) in zip(comps, tables):
                if (ss == 0 and ah == 0 and td not in dc_tabs) or \
                        (se > 0 and ta not in ac_tabs) or td > 3 or ta > 3:
                    raise ValueError("JPEG scan uses an undefined Huffman "
                                     "table")
                if c not in quants:     # latched at the first scan
                    if tq[c] not in qtabs:
                        raise ValueError("JPEG component uses an undefined "
                                         "quantisation table")
                    quants[c] = qtabs[tq[c]]
                band = coef_bits[c, ss:se + 1]
                want = -1 if ah == 0 else ah
                if (band != want).any() or (ah and al != ah - 1):
                    raise ValueError(f"JPEG progressive scan {ss}..{se} "
                                     f"bits {ah}/{al} out of sequence")
                band[:] = al
            seg_data, seg, pos = _entropy_data(data, pos)
            code = entropy(frame, Scan(comps, tables, ss, se, ah, al,
                                       restart, seg_data, seg), coefs, luts)
            if code:
                raise ValueError(
                    {1: "truncated or corrupt JPEG scan (its data runs out)",
                     2: "corrupt JPEG scan (an undefined Huffman code)",
                     3: "corrupt JPEG scan (a coefficient past its band)",
                     4: "corrupt JPEG scan (restart markers do not match "
                        "its MCUs)"}.get(code, f"JPEG scan error {code}"))
        elif marker in (0xD8,) or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            raise ValueError(f"JPEG marker 0xFF{marker:02X} out of place")
        elif marker == 0xDC:
            raise ValueError("JPEG DNL marker is not read here")
    if frame is None:
        raise ValueError("JPEG has no frame header")
    if (coef_bits != 0).any():
        raise ValueError("JPEG whose scans leave coefficient bits unknown "
                         "(libjpeg smooths such blocks) is not read here")
    return pixels(frame, coefs, [quants[c] for c in range(len(ids))])


def read_jpeg(path: str, native: bool = False) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), native)



def write_jpeg(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb))
