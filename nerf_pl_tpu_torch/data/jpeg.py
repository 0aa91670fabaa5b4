"""A JPEG reader giving what Pillow's ``Image.open(p)`` gives (libjpeg-turbo's
default decode), for every JPEG layout Pillow decodes.

Frames: sequential (SOF0, SOF1) and progressive (SOF2) DCT with Huffman
coding, the same two with arithmetic coding (SOF9, SOF10, with DAC
conditioning), and lossless (SOF3, predictors 1-7, the point transform);
8-bit samples; 1 component (``L``), 3 (``RGB``: YCbCr, or RGB under Adobe
transform 0 or the component ids ``R G B``) or 4 (``CMYK``: CMYK, or YCCK
under Adobe transform 2, with Pillow's Adobe polarity, every value
inverted); any sampling factors libjpeg-turbo takes (each component's
factors dividing the largest ones); restart intervals; interleaved or
one-component scans.  APPn and COM segments are skipped and no EXIF
rotation is applied (``Image.open`` applies none).  To give libjpeg-turbo's
bits it repeats:

  * the entropy decoders of ``jdhuff.c``, ``jdphuff.c``, ``jdarith.c`` and
    ``jdlhuff.c``, in C++ (``csrc/jpeg_entropy.cpp``), into quantised
    coefficients;
  * the integer "islow" inverse DCT (``jidctint.c``: 13-bit constants, two
    passes with 2 extra bits between them, rounded shifts) and its
    range-limit table (the output wraps modulo 1024 before the clamp), in the
    same C++ source;
  * the upsampling of ``jdsample.c``: "fancy" (triangle) ``h2v1``, ``h2v2``
    and ``h1v2`` (3/4 and 1/4 weights, the edges replicated, their rounding
    biases), box replication where a component is 2 samples wide or less or
    the frame is lossless, and the generic integer replication for the other
    ratios; with fancy upsampling on, ``jdmaster.c`` never takes the merged
    upsampler;
  * the fixed-point YCbCr -> RGB and YCCK -> CMYK tables of ``jdcolor.c``
    (16 fraction bits), in the C++ source;
  * ``jdcoefct.c``'s block smoothing of a progressive frame whose scans
    leave some of its first 10 zigzag coefficients unsent or unrefined: each
    such zero coefficient estimated from the 5x5 blocks' DC values around
    it (with the DC itself where none of the 10 was sent), in numpy.

What Pillow refuses raises ``ValueError`` naming the file and what it
found: samples of other than 8 bits, 2 components, hierarchical frames
(SOF5-7, SOF13-15), lossless arithmetic-coded frames (SOF11), fractional
sampling ratios, an interleaved MCU of more than 10 blocks, lossless YCbCr
or YCCK (libjpeg-turbo converts no colour in lossless mode), an
arithmetic-coded scan whose decoder reads past the bytes Pillow has fed
libjpeg in its 64 KiB blocks (``_PILLOW_BLOCK``), a file that ends before
its EOI.

The numpy code below is each C++ stage's plain version (the tests hold the
two bit for bit): ``_decode_scan`` the baseline Huffman stage (a per-symbol
loop, the one stage kept in Python only for that), ``_idct_blocks`` the
IDCT, ``_ycc_to_rgb`` the colour conversion.
"""
from __future__ import annotations

import ctypes
import re
import threading
import time
from array import array
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from . import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "jpeg_entropy.cpp"

# natural (row-major) index of each zigzag position
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63], np.int64)
_SOF_KINDS = {
    0xC0: "baseline DCT", 0xC1: "extended sequential DCT",
    0xC2: "progressive DCT", 0xC3: "lossless",
    0xC5: "differential sequential DCT", 0xC6: "differential progressive DCT",
    0xC7: "differential lossless",
    0xC9: "extended sequential DCT, arithmetic-coded",
    0xCA: "progressive DCT, arithmetic-coded",
    0xCB: "lossless, arithmetic-coded",
    0xCD: "differential sequential DCT, arithmetic-coded",
    0xCE: "differential progressive DCT, arithmetic-coded",
    0xCF: "differential lossless, arithmetic-coded",
}
_READ = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA)
# the end of an entropy-coded segment: a marker other than a stuffed 0 byte
# or a restart marker
_SEG_END = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RST = re.compile(rb"\xff[\xd0-\xd7]")
# libjpeg's D_MAX_BLOCKS_IN_MCU
_MAX_BLOCKS_IN_MCU = 10
# Pillow feeds libjpeg-turbo the file in blocks of ImageFile.MAXBLOCK bytes,
# the next one when libjpeg suspends for want of data; its arithmetic
# decoder cannot suspend, so a byte it reads past what has been fed makes
# Pillow raise "broken data stream"
_PILLOW_BLOCK = 65536


class _Unsupported(ValueError):
    pass


# ---------------------------------------------------- the native stages
_lock = threading.Lock()
_lib = None


def _native():
    """The C++ stages, built from ``csrc/jpeg_entropy.cpp`` at first use (a
    failed build raises, naming the source)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SOURCE)))
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            lib.jpeg_scan.restype = ctypes.c_int
            lib.jpeg_scan.argtypes = [vp, i64, vp, vp, vp, vp, i32, vp,
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_lossless_scan.restype = ctypes.c_int
            lib.jpeg_lossless_scan.argtypes = [vp, i64, vp, vp, vp, vp, i32,
                                               ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_idct_islow.restype = None
            lib.jpeg_idct_islow.argtypes = [vp, vp, i64, i64, vp]
            lib.jpeg_ycc_rgb.restype = None
            lib.jpeg_ycc_rgb.argtypes = [vp, vp, vp, vp, i64, vp]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ---------------------------------------------------------------- Huffman
def _extend(bits: np.ndarray, s: np.ndarray) -> np.ndarray:
    """JPEG's sign extension of an ``s``-bit magnitude category value."""
    return np.where(bits < (1 << np.maximum(s - 1, 0)),
                    bits - (1 << s) + 1, bits)


def _lookup(counts, symbols, ac: bool) -> List[tuple]:
    """A 65,536-entry table over a 16-bit peek: ``(bits, run, value,
    extra)``.  ``bits`` is what the entry consumes (0: no such code); the
    value's ``extra`` bits are already in ``value`` where code and bits fit
    in 16, else ``extra`` of them are still to read.  AC entries: EOB has run
    64; ZRL run 15 and value 0.  DC entries: run 0, value the difference."""
    length = np.zeros(65536, np.int64)
    symbol = np.zeros(65536, np.int64)
    code, k = 0, 0
    for L in range(1, 17):
        for _ in range(counts[L - 1]):
            lo = code << (16 - L)
            hi = (code + 1) << (16 - L)
            length[lo:hi] = L
            symbol[lo:hi] = symbols[k]
            code += 1
            k += 1
        if code >= 1 << L:  # no code may be all ones (jdhuff.c)
            raise _Unsupported("a Huffman table that overflows its codes")
        code <<= 1
    peek = np.arange(65536, dtype=np.int64)
    if ac:
        run, s = symbol >> 4, symbol & 15
    else:
        run, s = np.zeros_like(symbol), symbol
    fits = length + s <= 16
    bits = (peek >> np.maximum(16 - length - s, 0)) & ((1 << s) - 1)
    value = np.where(s > 0, _extend(bits, s), 0)
    total = np.where(fits, length + s, length)
    value = np.where(fits, value, 0)
    extra = np.where(fits, 0, s)
    if ac:
        run = np.where(symbol == 0, 64, run)  # EOB
    total = np.where(length > 0, total, 0)
    return list(zip(total.tolist(), run.tolist(), value.tolist(),
                    extra.tolist()))


def _windows(seg: bytes) -> array:
    """32-bit big-endian windows at every byte of ``seg`` (zero past its
    end, as libjpeg fills an exhausted stream)."""
    b = np.frombuffer(seg + b"\0\0\0\0", np.uint8).astype(np.uint32)
    w = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    out = array("I")
    out.frombytes(w.astype("=u4").tobytes())
    return out


def _decode_scan(frame: "_Frame", scan: "_Scan", tables: "_Tables",
                 data: bytes) -> None:
    """The plain version of the baseline Huffman stage: one sequential
    scan's segment(s) into ``frame.coef``, a per-symbol Python loop."""
    restart = tables.restart
    # split at the restart markers first: a stuffed 0xFF 0x00 may be
    # followed by a byte that looks like one
    segments = [s.replace(b"\xff\x00", b"\xff") for s in _RST.split(data)]
    zz = _ZIGZAG.tolist()
    luts = {}
    for ci, td, ta in zip(scan.comps, scan.td, scan.ta):
        if (0, td) not in tables.huff or (1, ta) not in tables.huff:
            raise _Unsupported("a scan naming a missing Huffman table")
        luts[ci] = (_lookup(*tables.huff[(0, td)], ac=False),
                    _lookup(*tables.huff[(1, ta)], ac=True))
    units = []
    if len(scan.comps) == 1:
        ci = scan.comps[0]
        bw, bh = frame.scan_blocks(ci)
        units = [[(ci, (by * frame.nbx[ci] + bx) * 64)]
                 for by in range(bh) for bx in range(bw)]
    else:
        for my in range(frame.mcuy):
            for mx in range(frame.mcux):
                unit = []
                for ci in scan.comps:
                    h, v = frame.hv[ci]
                    for yy in range(v):
                        for xx in range(h):
                            unit.append((ci, ((my * v + yy) * frame.nbx[ci]
                                              + mx * h + xx) * 64))
                units.append(unit)
    idx = {ci: array("q") for ci in scan.comps}
    val = {ci: array("i") for ci in scan.comps}
    pred = {ci: 0 for ci in scan.comps}
    seg = 0
    win = _windows(segments[0])
    pos = 0
    for n, unit in enumerate(units):
        if restart and n and n % restart == 0:
            seg += 1
            if seg >= len(segments):
                raise _Unsupported("a scan with fewer restart intervals than "
                                   "its DRI asks for")
            win, pos = _windows(segments[seg]), 0
            pred = {ci: 0 for ci in scan.comps}
        for ci, base in unit:
            dc, ac = luts[ci]
            put_i, put_v = idx[ci].append, val[ci].append
            # DC: the difference from the component's last DC value
            nb, _, diff, extra = dc[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not nb:
                raise _Unsupported("a corrupt Huffman code")
            pos += nb
            if extra:
                bits = (win[pos >> 3] >> (32 - (pos & 7) - extra)) & ((1 << extra) - 1)
                pos += extra
                diff = bits if bits >= 1 << (extra - 1) else bits - (1 << extra) + 1
            pred[ci] += diff
            put_i(base)
            put_v(pred[ci])
            k = 1
            while k < 64:
                nb, run, value, extra = ac[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not nb:
                    raise _Unsupported("a corrupt Huffman code")
                pos += nb
                if run == 64:  # EOB
                    break
                k += run
                if extra:
                    bits = (win[pos >> 3] >> (32 - (pos & 7) - extra)) & ((1 << extra) - 1)
                    pos += extra
                    value = bits if bits >= 1 << (extra - 1) else bits - (1 << extra) + 1
                if value:
                    if k > 63:
                        raise _Unsupported("a block with more than 64 "
                                           "coefficients")
                    put_i(base + zz[k])
                    put_v(value)
                k += 1
    for ci in scan.comps:
        if len(idx[ci]):
            frame.coef[ci][np.frombuffer(idx[ci], np.int64)] = np.frombuffer(
                val[ci], np.int32).astype(np.int16)


# -------------------------------------------------------------- the IDCT
_CONST_BITS, _PASS1_BITS = 13, 2
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)
# jdmaster.c's post-IDCT range limit, indexed by (x & 1023): x + 128 clamped
# to [0, 255] for x in [-512, 511], wrapping outside
_RANGE = np.concatenate([np.arange(128, 256), np.full(384, 255),
                         np.zeros(384), np.arange(0, 128)]).astype(np.uint8)


def _idct_1d(x, shift: int):
    """One pass of ``jpeg_idct_islow`` over axis 1 of ``x`` (..., 8, ...),
    descaled by ``shift`` (rounded: ``(v + 2^(shift-1)) >> shift``)."""
    f = _F
    z2, z3 = x[:, 2], x[:, 6]
    z1 = (z2 + z3) * f["f0541"]
    tmp2 = z1 + z3 * -f["f1847"]
    tmp3 = z1 + z2 * f["f0765"]
    tmp0 = (x[:, 0] + x[:, 4]) << _CONST_BITS
    tmp1 = (x[:, 0] - x[:, 4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0 = t0 * f["f0298"]
    t1 = t1 * f["f2053"]
    t2 = t2 * f["f3072"]
    t3 = t3 * f["f1501"]
    z1 = z1 * -f["f0899"]
    z2 = z2 * -f["f2562"]
    z3 = z3 * -f["f1961"] + z5
    z4 = z4 * -f["f0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    rnd = 1 << (shift - 1)
    out = np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                    tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], axis=1)
    return (out + rnd) >> shift


def _idct_blocks(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """The plain IDCT: (N, 64) natural-order coefficients -> (N, 8, 8)
    uint8 samples."""
    out = np.empty((coef.shape[0], 8, 8), np.uint8)
    step = 16384
    for lo in range(0, coef.shape[0], step):
        blk = (coef[lo:lo + step].astype(np.int64) * quant).reshape(-1, 8, 8)
        # pass 1: columns (axis 1 is the row index within each column)
        ws = _idct_1d(blk, _CONST_BITS - _PASS1_BITS)
        # pass 2: rows
        px = _idct_1d(ws.transpose(0, 2, 1), _CONST_BITS + _PASS1_BITS + 3)
        out[lo:lo + step] = _RANGE[px.transpose(0, 2, 1) & 1023]
    return out


def _idct_plane(coef: np.ndarray, quant: np.ndarray, nbx: int, nby: int,
                plain: bool) -> np.ndarray:
    """A component's coefficient plane -> its (nby * 8, nbx * 8) samples."""
    if plain:
        blocks = _idct_blocks(coef.reshape(-1, 64), quant)
        return blocks.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(
            nby * 8, nbx * 8)
    out = np.empty((nby * 8, nbx * 8), np.uint8)
    q = np.ascontiguousarray(quant, np.int32)
    _native().jpeg_idct_islow(_ptr(coef), _ptr(q), nbx, nby, _ptr(out))
    return out


# ----------------------------------------------- upsampling and colour
def _fancy_h2v1(p: np.ndarray) -> np.ndarray:
    """``h2v1_fancy_upsample``: each output 3/4 its nearer input and 1/4 the
    other neighbour, +1 (left) / +2 (right) before the shift."""
    x = p.astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.uint8)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def _fancy_h1v2(p: np.ndarray) -> np.ndarray:
    """``h1v2_fancy_upsample``: each output row 3/4 its nearer input row and
    1/4 the other neighbour, +1 (upper) / +2 (lower) before the shift; the
    rows above the first and below the last are copies of them."""
    x = p.astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.uint8)
    out[0::2] = (3 * x + up + 1) >> 2
    out[1::2] = (3 * x + down + 2) >> 2
    return out


def _fancy_h2v2(p: np.ndarray) -> np.ndarray:
    """``h2v2_fancy_upsample``: 9/16, 3/16, 3/16, 1/16 of the four nearest
    inputs (column sums of 3 x nearer + farther row), +8 / +7 before the
    shift; the rows above the first and below the last are copies of them
    (``jdmainct.c``'s context rows)."""
    x = p.astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.uint8)
    for r, other in ((0, up), (1, down)):
        col = 3 * x + other
        left = np.concatenate([col[:, :1], col[:, :-1]], 1)
        right = np.concatenate([col[:, 1:], col[:, -1:]], 1)
        out[r::2, 0::2] = (3 * col + left + 8) >> 4
        out[r::2, 1::2] = (3 * col + right + 7) >> 4
    return out


def _upsample(plane: np.ndarray, hv, hmax: int, vmax: int,
              fancy: bool = True) -> np.ndarray:
    """``jinit_upsampler``'s choice for one component of factors ``hv``
    (its plane cropped to its own size); ``fancy`` is off for lossless
    frames, whose 1x1 data units make ``min_DCT_scaled_size`` 1."""
    h, v = hv
    if (h, v) == (hmax, vmax):
        return plane
    wide = fancy and plane.shape[1] > 2
    if 2 * h == hmax and v == vmax and wide:
        return _fancy_h2v1(plane)
    if h == hmax and 2 * v == vmax and fancy:
        return _fancy_h1v2(plane)
    if 2 * h == hmax and 2 * v == vmax and wide:
        return _fancy_h2v2(plane)
    if hmax % h or vmax % v:
        raise _Unsupported(f"a fractional sampling ratio ({h}x{v} under "
                           f"{hmax}x{vmax})")
    return np.repeat(np.repeat(plane, vmax // v, 0), hmax // h, 1)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """The plain colour conversion: ``ycc_rgb_convert`` with
    ``build_ycc_rgb_table``'s fixed point."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (_fix(1.40200) * x + half) >> 16
    cb_b = (_fix(1.77200) * x + half) >> 16
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _colour(planes: List[np.ndarray], plain: bool) -> np.ndarray:
    """YCbCr -> RGB (3 planes) or YCCK -> CMYK (4 planes), as libjpeg
    writes them."""
    if plain:
        rgb = _ycc_to_rgb(*planes[:3])
        if len(planes) == 3:
            return rgb
        return np.concatenate([255 - rgb, planes[3][..., None]], -1)
    h, w = planes[0].shape
    flat = [np.ascontiguousarray(p) for p in planes]
    out = np.empty((h, w, len(planes)), np.uint8)
    k = _ptr(flat[3]) if len(flat) == 4 else None
    _native().jpeg_ycc_rgb(_ptr(flat[0]), _ptr(flat[1]), _ptr(flat[2]), k,
                           h * w, _ptr(out))
    return out


# ------------------------------------------------------------- decoding
class _Frame:
    def __init__(self, kind: int, body: bytes):
        precision, self.h, self.w, n = (body[0], int.from_bytes(body[1:3], "big"),
                                        int.from_bytes(body[3:5], "big"), body[5])
        if kind not in _READ:
            raise _Unsupported(f"a {_SOF_KINDS.get(kind, hex(kind))} frame "
                               f"(SOF{kind - 0xC0})")
        if precision != 8:
            raise _Unsupported(f"{precision}-bit samples (SOF{kind - 0xC0})")
        if n not in (1, 3, 4):
            raise _Unsupported(f"{n} components")
        if self.h == 0 or self.w == 0:
            raise _Unsupported("a frame without its height (DNL)")
        self.progressive = kind in (0xC2, 0xCA)
        self.arith = kind in (0xC9, 0xCA)
        self.lossless = kind == 0xC3
        self.ids, self.hv, self.tq = [], [], []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                raise _Unsupported(f"sampling factors {hv >> 4}x{hv & 15}")
            self.ids.append(cid)
            self.hv.append((hv >> 4, hv & 15))
            self.tq.append(tq)
        self.hmax = max(h for h, _ in self.hv)
        self.vmax = max(v for _, v in self.hv)
        unit = 1 if self.lossless else 8
        self.mcux = -(-self.w // (unit * self.hmax))
        self.mcuy = -(-self.h // (unit * self.vmax))
        # each component's block grid, padded to whole MCUs
        self.nbx = [self.mcux * h for h, _ in self.hv]
        self.nby = [self.mcuy * v for _, v in self.hv]
        if self.lossless:
            self.samples = [np.zeros((ch, cw), np.uint16)
                            for cw, ch in (self.comp_size(c) for c in range(n))]
            self.coef = []
        else:
            self.coef = [np.zeros(x * y * 64, np.int16)
                         for x, y in zip(self.nbx, self.nby)]
        # the last Al each zigzag coefficient was coded at (-1: not yet)
        self.coef_bits = np.full((n, 64), -1, np.int64)
        self.scanned = [False] * n

    def comp_size(self, ci: int) -> Tuple[int, int]:
        """A component's own (width, height) in samples."""
        h, v = self.hv[ci]
        return -(-self.w * h // self.hmax), -(-self.h * v // self.vmax)

    def scan_blocks(self, ci: int) -> Tuple[int, int]:
        """The blocks a one-component scan of ``ci`` covers."""
        cw, ch = self.comp_size(ci)
        return -(-cw // 8), -(-ch // 8)


class _Scan:
    def __init__(self, frame: _Frame, body: bytes):
        ns = body[0]
        if not 1 <= ns <= 4 or len(body) < 4 + 2 * ns:
            raise _Unsupported(f"a scan of {ns} components")
        self.comps, self.td, self.ta = [], [], []
        for j in range(ns):
            cid, t = body[1 + 2 * j], body[2 + 2 * j]
            if cid not in frame.ids:
                raise _Unsupported(f"a scan naming component {cid}, not in "
                                   "its frame")
            if not frame.arith and (t >> 4 > 3 or t & 15 > 3):
                raise _Unsupported(f"a scan naming Huffman tables {t:#04x} "
                                   "(ids 0-3)")
            self.comps.append(frame.ids.index(cid))
            self.td.append(t >> 4)
            self.ta.append(t & 15)
        self.ss, self.se, a = body[1 + 2 * ns:4 + 2 * ns]
        self.ah, self.al = a >> 4, a & 15
        if ns > 1 and sum(frame.hv[c][0] * frame.hv[c][1]
                          for c in self.comps) > _MAX_BLOCKS_IN_MCU:
            raise _Unsupported("an MCU of more than 10 blocks")


class _Tables:
    """The tables in force: quantisation, Huffman (``(class, id) ->
    (counts, symbols)``), arithmetic conditioning, restart interval."""

    def __init__(self):
        self.quant: Dict[int, np.ndarray] = {}
        self.huff: Dict[Tuple[int, int], Tuple[bytes, bytes]] = {}
        # DAC defaults (T.81 F.1.4.4): L = 0, U = 1, Kx = 5; libjpeg keeps
        # 16 arithmetic tables of each class
        self.dc_l, self.dc_u, self.ac_k = [0] * 16, [1] * 16, [5] * 16
        self.restart = 0


def _check_progression(frame: _Frame, scan: _Scan) -> None:
    """``start_pass_phuff_decoder``'s validation, and the coefficients'
    precision bookkeeping (libjpeg's ``coef_bits``)."""
    bad = scan.se != 0 if scan.ss == 0 else (
        scan.ss > scan.se or scan.se > 63 or len(scan.comps) != 1)
    bad |= scan.ah != 0 and scan.al != scan.ah - 1
    bad |= scan.al > 13
    if bad:
        raise _Unsupported("an invalid progression (Ss, Se, Ah, Al = "
                           f"{scan.ss}, {scan.se}, {scan.ah}, {scan.al})")
    for ci in scan.comps:
        frame.coef_bits[ci, scan.ss:scan.se + 1] = scan.al


def _native_scan(frame: _Frame, scan: _Scan, tables: _Tables,
                 data: bytes) -> int:
    """One scan through the C++ entropy stage; returns the index in
    ``data`` of the last byte an arithmetic decoder reads (``len(data)``:
    the marker after it; -1: none, or a Huffman scan)."""
    ns = len(scan.comps)
    geo = np.zeros((ns, 8), np.int32)
    for j, ci in enumerate(scan.comps):
        bw, bh = frame.scan_blocks(ci)
        geo[j] = (frame.nbx[ci], bw, bh, *frame.hv[ci], scan.td[j],
                  scan.ta[j], 0)
    params = np.array([ns, frame.mcux, frame.mcuy, scan.ss, scan.se, scan.ah,
                       scan.al, tables.restart, frame.arith,
                       frame.progressive], np.int32)
    huff = np.zeros((8, 272), np.uint8)
    present = 0
    for (tc, th), (counts, symbols) in tables.huff.items():
        if th < 4:
            t = tc * 4 + th
            huff[t, :16] = np.frombuffer(counts, np.uint8)
            huff[t, 16:16 + len(symbols)] = np.frombuffer(symbols, np.uint8)
            present |= 1 << t
    cond = np.array(tables.dc_l + tables.dc_u + tables.ac_k, np.int32)
    planes = (ctypes.c_void_p * ns)(*[frame.coef[ci].ctypes.data
                                      for ci in scan.comps])
    err = ctypes.create_string_buffer(256)
    buf = np.frombuffer(data, np.uint8)
    last = ctypes.c_int64(-1)
    rc = _native().jpeg_scan(_ptr(buf), len(data), _ptr(params), _ptr(geo),
                             ctypes.cast(planes, ctypes.c_void_p), _ptr(huff),
                             present, _ptr(cond), ctypes.byref(last), err,
                             len(err))
    if rc != 0:
        raise _Unsupported(err.value.decode())
    return last.value


def _lossless_scan(frame: _Frame, scan: _Scan, tables: _Tables,
                   data: bytes) -> None:
    """One lossless scan through the C++ stage (``scan.ss`` is the
    predictor, ``scan.al`` the point transform)."""
    if not 1 <= scan.ss <= 7:
        raise _Unsupported(f"a lossless predictor of {scan.ss}")
    ns = len(scan.comps)
    geo = np.zeros((ns, 5), np.int32)
    for j, ci in enumerate(scan.comps):
        geo[j] = (*frame.comp_size(ci), *frame.hv[ci], scan.td[j])
    params = np.array([ns, frame.mcux, frame.mcuy, scan.ss, scan.al,
                       tables.restart, 8], np.int32)
    huff = np.zeros((4, 272), np.uint8)
    present = 0
    for (tc, th), (counts, symbols) in tables.huff.items():
        if tc == 0 and th < 4:
            huff[th, :16] = np.frombuffer(counts, np.uint8)
            huff[th, 16:16 + len(symbols)] = np.frombuffer(symbols, np.uint8)
            present |= 1 << th
    out = (ctypes.c_void_p * ns)(*[frame.samples[ci].ctypes.data
                                   for ci in scan.comps])
    err = ctypes.create_string_buffer(256)
    buf = np.frombuffer(data, np.uint8)
    rc = _native().jpeg_lossless_scan(
        _ptr(buf), len(data), _ptr(params), _ptr(geo),
        ctypes.cast(out, ctypes.c_void_p), _ptr(huff), present, err, len(err))
    if rc != 0:
        raise _Unsupported(err.value.decode())
    for ci in scan.comps:
        frame.samples[ci] <<= scan.al


def _decode(data: bytes, plain: bool = False):
    """Parse the markers and entropy-decode every scan: ``(frame, tables,
    colour space)``.  ``plain`` decodes through ``_decode_scan`` (baseline
    Huffman only)."""
    if data[:2] != b"\xff\xd8":
        raise _Unsupported("not a JPEG file (no SOI)")
    pos, frame = 2, None
    tables = _Tables()
    adobe, jfif = None, False
    fed = _PILLOW_BLOCK  # the bytes Pillow has fed libjpeg so far

    def feed(end: int) -> None:
        """libjpeg reads (and may wait for) the bytes before ``end``."""
        nonlocal fed
        fed = max(fed, -(-end // _PILLOW_BLOCK) * _PILLOW_BLOCK)

    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            raise _Unsupported("a JPEG that ends before its EOI")
        marker = data[pos + 1]
        if marker in (0xFF, 0x00):  # fill byte
            pos += 1
            continue
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        n = int.from_bytes(data[pos:pos + 2], "big")
        if n < 2 or pos + n > len(data):
            raise _Unsupported("a JPEG that ends before its EOI")
        body, pos = data[pos + 2:pos + n], pos + n
        feed(pos)
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                width = 2 if pq else 1
                vals = np.frombuffer(body[i + 1:i + 1 + 64 * width],
                                     ">u2" if pq else np.uint8)
                if len(vals) != 64:
                    raise _Unsupported("a cut quantisation table")
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = vals
                tables.quant[tq] = q
                i += 1 + 64 * width
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                m = sum(counts)
                tables.huff[(tc, th)] = (counts, body[i + 17:i + 17 + m])
                i += 17 + m
        elif marker == 0xCC:  # DAC (jdmarker.c get_dac)
            for i in range(0, len(body) - 1, 2):
                tc, tb, cs = body[i] >> 4, body[i] & 15, body[i + 1]
                if tc > 1:
                    raise _Unsupported(f"a DAC naming table {body[i]:#04x}")
                if tc == 0:
                    tables.dc_l[tb], tables.dc_u[tb] = cs & 15, cs >> 4
                    if tables.dc_l[tb] > tables.dc_u[tb]:
                        raise _Unsupported(f"a DAC with L > U ({cs:#x})")
                else:
                    tables.ac_k[tb] = cs
        elif marker == 0xDD:  # DRI
            tables.restart = int.from_bytes(body[:2], "big")
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if frame is not None:
                raise _Unsupported("more than one frame")
            frame = _Frame(marker, body)
        elif marker == 0xDC:
            raise _Unsupported("a DNL marker")
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise _Unsupported("a scan before its frame")
            scan = _Scan(frame, body)
            m = _SEG_END.search(data, pos)
            end = m.start() if m else len(data)
            for ci in scan.comps:
                frame.scanned[ci] = True
            if frame.lossless:
                _lossless_scan(frame, scan, tables, data[pos:end])
            else:
                if frame.progressive:
                    _check_progression(frame, scan)
                if plain:
                    if frame.progressive or frame.arith:
                        raise _Unsupported("the plain stage reads sequential "
                                           "Huffman scans only")
                    _decode_scan(frame, scan, tables, data[pos:end])
                else:
                    last = _native_scan(frame, scan, tables, data[pos:end])
                    if last >= end - pos:  # through the marker's code byte
                        last = end + len(data[end:]) - len(
                            data[end:].lstrip(b"\xff"))
                    elif last >= 0:
                        last += pos
                    if frame.arith and last >= fed:
                        raise _Unsupported(
                            "an arithmetic-coded scan read past Pillow's first "
                            f"{fed:,} bytes: libjpeg-turbo's arithmetic decoder "
                            "cannot wait for Pillow's next 64 KiB block, and "
                            "Pillow raises 'broken data stream'")
            if not frame.arith:
                feed(end + 2)
            pos = end
    if frame is None:
        raise _Unsupported("no frame")
    if not all(frame.scanned):
        raise _Unsupported("a component without a scan")
    return frame, tables, _colour_space(frame, adobe, jfif)


def _colour_space(frame: _Frame, adobe, jfif: bool) -> str:
    """libjpeg's ``default_decompress_parms`` guess of the stored colour
    space."""
    n = len(frame.ids)
    if n == 1:
        return "L"
    if n == 3:
        if jfif:
            space = "YCbCr"
        elif adobe is not None:
            space = "RGB" if adobe == 0 else "YCbCr"
        else:  # by the component ids; lossless frames assume RGB
            space = "RGB" if (frame.lossless or frame.ids == [82, 71, 66]) else "YCbCr"
    else:
        space = "YCCK" if adobe is not None and adobe != 0 else "CMYK"
    if frame.lossless and space in ("YCbCr", "YCCK"):
        raise _Unsupported(f"a lossless {space} frame (libjpeg-turbo converts "
                           "no colour in lossless mode)")
    return space


# jdcoefct.c's block smoothing: for each estimated coefficient (natural
# index, zigzag index) its 5x5 kernel over the quantised DC values around
# the block (rows -2..2 top to bottom, columns -2..2), without and with DC
# interpolation (``change_dc``: none of coefficients 1-9 was sent)
_SMOOTH = (
    (1, 1, [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-7, 50, 0, -50, 7],
            [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
     [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
      [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]]),
    (8, 2, [[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0, 0, 0, 0, 0],
            [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]],
     [[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0, 0, 0, 0, 0],
      [1, -13, -38, -13, 1], [1, 3, 3, 3, 1]]),
    (16, 3, [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0],
             [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]],
     [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
      [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]]),
    (9, 4, [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0, 0, 0, 0, 0],
            [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]],
     [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0],
      [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]]),
    (2, 5, [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-1, 13, -24, 13, -1],
            [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
     [[0, 0, 0, 0, 0], [0, 2, -5, 2, 0], [1, 7, -14, 7, 1],
      [0, 2, -5, 2, 0], [0, 0, 0, 0, 0]]),
    (3, 6, None, [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, 2, 0, -2, 0],
                  [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]]),
    (10, 7, None, [[0, 0, 0, 0, 0], [0, 1, -3, 1, 0], [0, 0, 0, 0, 0],
                   [0, -1, 3, -1, 0], [0, 0, 0, 0, 0]]),
    (17, 8, None, [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, -3, 0, 3, 0],
                   [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]]),
    (24, 9, None, [[0, 0, 0, 0, 0], [0, 1, 2, 1, 0], [0, 0, 0, 0, 0],
                   [0, -1, -2, -1, 0], [0, 0, 0, 0, 0]]),
)
_SMOOTH_DC = [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8],
              [-6, 6, 42, 6, -6], [-2, -6, -8, -6, -2]]


def _smoothing_ok(frame: _Frame, quant: Dict[int, np.ndarray]) -> bool:
    """``jdcoefct.c``'s ``smoothing_ok``: a progressive frame whose every
    component's DC is known, whose steps at the coefficients read are
    non-zero, and one of whose components has one of its first 10 zigzag
    coefficients not known to full precision."""
    if not frame.progressive:
        return False
    useful = False
    for ci in range(len(frame.ids)):
        if (quant[frame.tq[ci]][_ZIGZAG[:10]] == 0).any():
            return False
        bits = frame.coef_bits[ci]
        if bits[0] < 0:
            return False
        useful |= bool((bits[1:10] != 0).any())
    return useful


def _dc_window(dc: np.ndarray, frame: _Frame, ci: int) -> np.ndarray:
    """(bh, bw, 5, 5): each real block's neighbours' DC values as
    ``decompress_smooth_data`` reads them: rows through its per-iMCU-row
    tests, columns through its sliding registers (both replicate the edge
    blocks, with libjpeg-turbo's own choices near the last ones)."""
    bw, bh = frame.scan_blocks(ci)
    v, total = frame.hv[ci][1], frame.mcuy
    rows = []
    for r in range(total):
        block_rows = v if r < total - 1 else (bh % v or v)
        image_rows = block_rows * total
        for b in range(block_rows):
            y, i = r * v + b, r * block_rows + b
            prev = y - 1 if i > 0 else y
            prev2 = y - 2 if i > 1 else prev
            nxt = y + 1 if i < image_rows - 1 else y
            nxt2 = y + 2 if i < image_rows - 2 else nxt
            rows.append((prev2, prev, y, nxt, nxt2))
    picked = dc[np.array(rows)]  # (bh, 5, columns)
    cols = np.clip(np.arange(bw)[:, None] + np.arange(-2, 3)[None, :], 0, bw - 1)
    return picked[:, :, cols].transpose(0, 2, 1, 3)


def _smooth(frame: _Frame, quant: Dict[int, np.ndarray]) -> List[np.ndarray]:
    """``decompress_smooth_data``: each component's coefficients with the
    estimates of its zero coefficients not known to full precision."""
    out = []
    for ci, coef in enumerate(frame.coef):
        bw, bh = frame.scan_blocks(ci)
        plane = coef.reshape(frame.nby[ci], frame.nbx[ci], 64).copy()
        bits = frame.coef_bits[ci]
        q = quant[frame.tq[ci]].astype(np.int64)
        dc = plane[:, :, 0].astype(np.int64)
        win = _dc_window(dc, frame, ci)
        work = plane[:bh, :bw].astype(np.int64)
        change_dc = bool((bits[1:10] == -1).all())
        for nat, zz, kernel, kernel_dc in _SMOOTH:
            k = kernel_dc if change_dc else kernel
            al = int(bits[zz])
            if k is None or al == 0:
                continue
            num = q[0] * np.einsum("yxrc,rc->yx", win, np.array(k))
            qk = int(q[nat])
            pred = (((qk << 7) + np.abs(num)) // (qk << 8))
            if al > 0:
                pred = np.minimum(pred, (1 << al) - 1)
            pred = np.where(num >= 0, pred, -pred)
            work[..., nat] = np.where(work[..., nat] == 0, pred, work[..., nat])
        if change_dc:
            num = q[0] * np.einsum("yxrc,rc->yx", win, np.array(_SMOOTH_DC))
            pred = ((q[0] << 7) + np.abs(num)) // (q[0] << 8)
            work[..., 0] = np.where(num >= 0, pred, -pred)
        plane[:bh, :bw] = work.astype(np.int16)
        out.append(plane.reshape(-1))
    return out


def _pixels(frame: _Frame, tables: _Tables, space: str, plain: bool,
            seconds: dict):
    """The decoded frame as Pillow gives it: ``(array, mode)``; each
    stage's seconds added to ``seconds``."""
    planes = []
    clock = time.perf_counter
    coef = (_smooth(frame, tables.quant) if _smoothing_ok(frame, tables.quant)
            else frame.coef)

    def lap(stage, t0):
        seconds[stage] = seconds.get(stage, 0.0) + clock() - t0

    for ci in range(len(frame.ids)):
        cw, ch = frame.comp_size(ci)
        t0 = clock()
        if frame.lossless:
            plane = frame.samples[ci].astype(np.uint8)
        else:
            if frame.tq[ci] not in tables.quant:
                raise _Unsupported(f"component {ci} names a missing "
                                   f"quantisation table {frame.tq[ci]}")
            plane = _idct_plane(coef[ci], tables.quant[frame.tq[ci]],
                                frame.nbx[ci], frame.nby[ci], plain)
        lap("idct", t0)
        t0 = clock()
        plane = _upsample(plane[:ch, :cw], frame.hv[ci], frame.hmax,
                          frame.vmax, fancy=not frame.lossless)
        planes.append(plane[:frame.h, :frame.w])
        lap("upsample", t0)
    t0 = clock()
    try:
        return _convert(planes, space, plain)
    finally:
        lap("colour", t0)


def _convert(planes: List[np.ndarray], space: str, plain: bool):
    if space == "L":
        return np.ascontiguousarray(planes[0]), "L"
    if space == "RGB":
        return np.stack(planes, -1), "RGB"
    if space == "CMYK":
        return 255 - np.stack(planes, -1), "CMYK"
    out = _colour(planes, plain)
    return (out, "RGB") if space == "YCbCr" else (255 - out, "CMYK")


def decode(data: bytes, plain: bool = False, seconds: dict = None):
    """``(array, mode)`` of a JPEG's bytes; ``plain`` runs the plain
    versions of the stages (baseline Huffman files only).  ``seconds``, if
    given, gets each stage's host seconds: ``entropy``, ``idct``,
    ``upsample``, ``colour``."""
    seconds = {} if seconds is None else seconds
    t0 = time.perf_counter()
    try:
        frame, tables, space = _decode(data, plain)
    except (IndexError, ValueError) as e:
        if isinstance(e, _Unsupported):
            raise
        raise _Unsupported(f"a cut or malformed segment ({e})") from None
    seconds["entropy"] = time.perf_counter() - t0
    return _pixels(frame, tables, space, plain, seconds)


def coefficients(data: bytes, plain: bool = False) -> List[np.ndarray]:
    """Each component's quantised coefficients: int16, natural order,
    ``(rows, columns, 64)`` over the blocks of its own size."""
    frame, _, _ = _decode(data, plain)
    out = []
    for ci, c in enumerate(frame.coef):
        bw, bh = frame.scan_blocks(ci)
        out.append(c.reshape(frame.nby[ci], frame.nbx[ci], 64)[:bh, :bw])
    return out


def read_jpeg(path: str):
    """``(array, mode)``: ``(H, W, 3)`` uint8 ``RGB``, ``(H, W)`` ``L`` or
    ``(H, W, 4)`` ``CMYK`` (Pillow's values: libjpeg's, inverted)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode(data)
    except _Unsupported as e:
        raise ValueError(f"{path}: unsupported JPEG: {e}") from None
