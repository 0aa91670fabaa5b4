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
  * the integer "islow" inverse DCT as libjpeg-turbo's x86 AVX2 code runs it
    (``jidctint-avx2.asm``: 13-bit constants, two passes with 2 extra bits
    between them, rounded shifts, products and some sums in 16-bit lanes,
    saturating packs), in the same C++ source;
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

A corrupt stream is read as libjpeg-turbo reads it, warnings ignored, as
Pillow ignores them: the markers through ``read_markers`` (an unknown one
raises); in a scan, bits past a marker read as zeros and the rest of that
restart interval is skipped, faulty restart markers resynchronise as
``jpeg_resync_to_restart`` does, a code no Huffman table holds reads 17 bits
and decodes as 0, a run past coefficient 63 writes at 63, a refinement of
magnitude above 1 reads one bit, an arithmetic decoder's overflow stops the
interval; a single-scan file that ends after its last MCU is read (Pillow
has its rows), and block smoothing past the last row begun with data left
takes the previous scan's precision.  What Pillow refuses raises
``ValueError`` naming the file and what it found: samples of other than 8
bits, 2 components, hierarchical frames (SOF5-7, SOF13-15), lossless
arithmetic-coded frames (SOF11), fractional sampling ratios, an interleaved
MCU of more than 10 blocks, lossless YCbCr or YCCK (libjpeg-turbo converts
no colour in lossless mode), an arithmetic-coded scan whose decoder reads
past the bytes Pillow has fed libjpeg in its 64 KiB blocks
(``_PILLOW_BLOCK``), a file that ends where libjpeg waits for more.

The numpy code below is each C++ stage's plain version (the tests hold the
two bit for bit): ``_decode_scan`` the baseline Huffman stage (a per-symbol
loop, the one stage kept in Python only for that), ``_idct_blocks`` the
IDCT, ``_ycc_to_rgb`` the colour conversion.
"""
from __future__ import annotations

import ctypes
import functools
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
# a marker (0xFF, any fill bytes, a code other than 0) and a stuffed 0xFF
# data byte, as libjpeg's readers take them
_MARKER = re.compile(rb"\xff+[^\x00\xff]")
_STUFFED = re.compile(rb"\xff+\x00")
# libjpeg's D_MAX_BLOCKS_IN_MCU
_MAX_BLOCKS_IN_MCU = 10
# Pillow feeds libjpeg-turbo the file in blocks of ImageFile.MAXBLOCK bytes,
# the next one when libjpeg suspends for want of data; its arithmetic
# decoder cannot suspend, so a byte it reads past what has been fed makes
# Pillow raise "broken data stream"
_PILLOW_BLOCK = 65536


class _Unsupported(ValueError):
    pass


class _Truncated(_Unsupported):
    """The data ends where libjpeg waits for more: Pillow raises "image file
    is truncated" (unless every row was already out)."""


# libjpeg's std_huff_tables (T.81 K.3): what a scan reads where no DHT has
# defined Huffman table 0 or 1 by the first SOS
_STD_HUFF = {
    (0, 0): ("00010501010101010100000000000000", "000102030405060708090a0b"),
    (0, 1): ("00030101010101010101010000000000", "000102030405060708090a0b"),
    (1, 0): ("0002010303020403050504040000017d",
             "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
             "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
             "535455565758595a636465666768696a737475767778797a838485868788898a"
             "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
             "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (1, 1): ("00020102040403040705040400010277",
             "000102031104052131061241510761711322328108144291a1b1c109233352f0"
             "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
             "494a535455565758595a636465666768696a737475767778797a828384858687"
             "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4"
             "c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}


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
            lib.jpeg_scan.argtypes = [vp, i64, vp, vp, vp, vp, i32, vp, vp,
                                      ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_lossless_scan.restype = ctypes.c_int
            lib.jpeg_lossless_scan.argtypes = [vp, i64, vp, vp, vp, vp, i32,
                                               vp, ctypes.c_char_p, ctypes.c_int]
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


@functools.lru_cache(maxsize=16)
def _lookup(counts: bytes, symbols: bytes, ac: bool) -> List[tuple]:
    """A 65,536-entry table over a 16-bit peek: ``(bits, run, value, extra,
    length, size)``.  ``bits`` is what the entry consumes; the value's
    ``extra`` bits are already in ``value`` where code and bits fit in 16,
    else ``extra`` of them are still to read; ``length`` is the code's and
    ``size`` its value's bits.  A peek no code matches reads 17 bits and
    decodes as symbol 0 (``jpeg_huff_decode``'s sentinel).  AC entries: EOB
    has run 64; ZRL run 15 and value 0.  DC entries: run 0, value the
    difference."""
    length = np.full(65536, 17, np.int64)
    symbol = np.zeros(65536, np.int64)
    code, k = 0, 0
    for L in range(1, 17):
        for _ in range(counts[L - 1]):
            if k >= 256:
                raise _Unsupported("a Huffman table with more than 256 codes")
            lo = code << (16 - L)
            hi = (code + 1) << (16 - L)
            length[lo:hi] = L
            symbol[lo:hi] = symbols[k]
            code += 1
            k += 1
        if code >= 1 << L:  # no code may be all ones (jdhuff.c)
            raise _Unsupported("a Huffman table that overflows its codes")
        code <<= 1
    if not ac and max(symbols[:k], default=0) > 15:
        raise _Unsupported("a DC Huffman table with a symbol above its "
                           "largest category")
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
    return list(zip(total.tolist(), run.tolist(), value.tolist(),
                    extra.tolist(), length.tolist(), s.tolist()))


def _windows(seg: bytes) -> array:
    """32-bit big-endian windows at every byte of ``seg`` and of the zeros
    libjpeg reads past its end (as many as an MCU of 10 blocks can take
    after the data ran out: 10 x 64 codes of 17 bits and values of 16)."""
    b = np.frombuffer(seg + bytes(2700), np.uint8).astype(np.uint32)
    w = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    out = array("I")
    out.frombytes(w.astype("=u4").tobytes())
    return out


def _segments(data: bytes) -> List[tuple]:
    """A scan's bytes to the end of the file split at each marker, as
    ``Segments`` in the C++ source: ``(bytes, code, after, start)`` with
    the stuffed zeros removed, the marker's code (-1: the file ends first),
    the index past its code byte and the segment's first index."""
    out, pos = [], 0
    while True:
        m = _MARKER.search(data, pos)
        raw = data[pos:m.start()] if m else data[pos:].rstrip(b"\xff")
        out.append((_STUFFED.sub(b"\xff", raw), data[m.end() - 1] if m else -1,
                    m.end() if m else len(data), pos))
        if m is None:
            return out
        pos = m.end()


def _raw_ends(data: bytes, start: int) -> List[int]:
    """The index in ``data`` of the last raw byte of each byte of the
    segment that starts at ``start`` and runs to the end of the file."""
    raw = data[start:].rstrip(b"\xff")
    ends, pos = [], 0
    for m in _STUFFED.finditer(raw):
        ends.extend(range(start + pos, start + m.start()))
        ends.append(start + m.end() - 1)
        pos = m.end()
    ends.extend(range(start + pos, start + len(raw)))
    return ends


class _Restarts:
    """``read_restart_marker`` and ``jpeg_resync_to_restart`` over the
    segments (``Restarts`` in the C++ source)."""

    def __init__(self, segs):
        self.segs, self.seg, self.pending, self.next_num = segs, 0, False, 0

    def marker(self) -> int:
        code = self.segs[self.seg][1]
        if code < 0:
            raise _Truncated("a JPEG that ends before its EOI (image file is "
                             "truncated: the scan's data ends with the file)")
        return code

    def read(self) -> bool:
        """Whether the decoder reads the next segment's data (the marker
        consumed) or none (the marker left unread)."""
        m, want = self.marker(), self.next_num
        consumed = m == 0xD0 + want
        while not consumed:
            if m < 0xC0:
                action = 2
            elif not 0xD0 <= m <= 0xD7:
                action = 3
            elif m in (0xD0 + ((want + 1) & 7), 0xD0 + ((want + 2) & 7)):
                action = 3
            elif m in (0xD0 + ((want - 1) & 7), 0xD0 + ((want - 2) & 7)):
                action = 2
            else:
                action = 1
            if action == 3:
                break
            if action == 1:
                consumed = True
                break
            self.seg += 1
            m = self.marker()
        self.seg += consumed
        self.pending = not consumed
        self.next_num = (want + 1) & 7
        return consumed


def _decode_scan(frame: "_Frame", scan: "_Scan", tables: "_Tables",
                 data: bytes) -> Tuple[int, int]:
    """The plain version of the baseline Huffman stage: one sequential
    scan from ``data`` (its bytes to the end of the file) into
    ``frame.coef``, a per-symbol Python loop with libjpeg's handling of a
    corrupt stream (``run_scan`` in the C++ source); returns the index past
    the marker after the scan and its code (-1, -1: the file ends)."""
    restart = tables.restart
    segs = _segments(data)
    zz = _ZIGZAG.tolist() + [63] * 16  # jpeg_natural_order's padding
    luts = {}
    for ci, td, ta in zip(scan.comps, scan.td, scan.ta):
        if (0, td) not in tables.huff or (1, ta) not in tables.huff:
            raise _Unsupported("a scan naming a missing Huffman table")
        luts[ci] = (_lookup(*map(bytes, tables.huff[(0, td)]), ac=False),
                    _lookup(*map(bytes, tables.huff[(1, ta)]), ac=True))
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
    rs = _Restarts(segs)
    state = {}

    def reading():
        seg, _, _, start = segs[rs.seg]
        seg = b"" if rs.pending else seg
        state.update(win=_windows(seg), nbits=8 * len(seg), fetched=0,
                     eof=not rs.pending and segs[rs.seg][1] < 0, start=start)

    def fill_slow(at):  # jpeg_fill_bit_buffer: the buffer up to 57 bits
        want = state["fetched"] + (57 - (state["fetched"] * 8 - at) + 7) // 8
        if want * 8 > state["nbits"]:
            rs.marker()  # the file ends: raises
        state["fetched"] = want

    def fill_fast(at):  # FILL_BIT_BUFFER_FAST
        if state["fetched"] * 8 - at <= 16:
            state["fetched"] += 6
            if state["fetched"] * 8 > state["nbits"]:
                rs.marker()

    def code_fetch(at, length, size, fast):
        """The refills libjpeg makes for a code of ``length`` bits (17: a
        corrupt one) and a value of ``size`` bits read from ``at``."""
        if fast:
            fill_fast(at)
        else:
            if state["fetched"] * 8 - at < 8:
                fill_slow(at)
            if length > 8:
                if state["fetched"] * 8 - at < 9:
                    fill_slow(at)
                for p in range(at + 9, at + length):
                    if state["fetched"] * 8 - p < 1:
                        fill_slow(p)
        if size:
            at += length
            if fast:
                fill_fast(at)
            elif state["fetched"] * 8 - at < size:
                fill_slow(at)

    reading()
    pos = 0
    pred = {ci: 0 for ci in scan.comps}
    insufficient = False
    blocks = len(units[0]) if units else 1
    ends = None
    for n, unit in enumerate(units):
        if restart and n and n % restart == 0:
            consumed = rs.read()
            reading()
            pos = 0
            pred = {ci: 0 for ci in scan.comps}
            insufficient &= not consumed
        if insufficient:
            continue
        win, eof = state["win"], state["eof"]
        fast = False
        if eof:
            if ends is None:
                ends = _raw_ends(data, state["start"])
            at = (ends[state["fetched"] - 1] + 1 if state["fetched"]
                  else state["start"])
            fast = not restart and len(data) - at >= 512 * blocks
        for ci, base in unit:
            dc, ac = luts[ci]
            put_i, put_v = idx[ci].append, val[ci].append
            # DC: the difference from the component's last DC value
            nb, _, diff, extra, length, size = dc[
                (win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if eof:
                code_fetch(pos, length, size, fast)
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
                nb, run, value, extra, length, size = ac[
                    (win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if eof:
                    code_fetch(pos, length, size, fast)
                pos += nb
                if run == 64:  # EOB
                    break
                k += run
                if extra:
                    bits = (win[pos >> 3] >> (32 - (pos & 7) - extra)) & ((1 << extra) - 1)
                    pos += extra
                    value = bits if bits >= 1 << (extra - 1) else bits - (1 << extra) + 1
                if size:
                    put_i(base + zz[k])
                    put_v(value)
                k += 1
        insufficient = pos > state["nbits"]
    for ci in scan.comps:
        if len(idx[ci]):
            frame.coef[ci][np.frombuffer(idx[ci], np.int64)] = np.frombuffer(
                val[ci], np.int32).astype(np.int16)
    _, code, after, _ = segs[rs.seg]
    return (after, code) if code >= 0 else (-1, -1)


# -------------------------------------------------------------- the IDCT
# libjpeg-turbo's x86-64 islow IDCT (jidctint-avx2.asm; the C++ source's
# comment has the details): products and the sums in0 +- in4, z3 and z4 in
# 16 bits (wrapping), each pass's outputs saturated to 16 bits, the samples
# to [-128, 127] before the +128; rows 1-7 all zero take pass 1's shortcut
_CONST_BITS, _PASS1_BITS = 13, 2
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _w16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(x):
    """One pass of the AVX2 ``dodct`` over axis 1 of ``x`` (..., 8, ...)
    of 16-bit values: the 32-bit sums before the descale."""
    f = _F
    tmp0 = _w16(x[:, 0] + x[:, 4]) << _CONST_BITS
    tmp1 = _w16(x[:, 0] - x[:, 4]) << _CONST_BITS
    tmp2 = x[:, 2] * f["f0541"] + x[:, 6] * (f["f0541"] - f["f1847"])
    tmp3 = x[:, 2] * (f["f0541"] + f["f0765"]) + x[:, 6] * f["f0541"]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z3, z4 = _w16(t0 + t2), _w16(t1 + t3)
    z3, z4 = (z3 * (f["f1175"] - f["f1961"]) + z4 * f["f1175"],
              z3 * f["f1175"] + z4 * (f["f1175"] - f["f0390"]))
    t0, t1, t2, t3 = (t0 * (f["f0298"] - f["f0899"]) - t3 * f["f0899"] + z3,
                      t1 * (f["f2053"] - f["f2562"]) - t2 * f["f2562"] + z4,
                      -t1 * f["f2562"] + t2 * (f["f3072"] - f["f2562"]) + z3,
                      -t0 * f["f0899"] + t3 * (f["f1501"] - f["f0899"]) + z4)
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], axis=1)


def _idct_blocks(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """The plain IDCT: (N, 64) natural-order coefficients -> (N, 8, 8)
    uint8 samples."""
    out = np.empty((coef.shape[0], 8, 8), np.uint8)
    step = 16384
    for lo in range(0, coef.shape[0], step):
        c = coef[lo:lo + step].astype(np.int64)
        blk = _w16(c * quant).reshape(-1, 8, 8)
        # pass 1: columns (axis 1 is the row index within each column)
        ws = np.clip((_idct_1d(blk) + (1 << 10)) >> 11, -32768, 32767)
        dc = _w16(blk[:, 0, :] << _PASS1_BITS)
        ws = np.where((c[:, 8:] == 0).all(1)[:, None, None], dc[:, None, :], ws)
        # pass 2: rows
        px = _idct_1d(ws.transpose(0, 2, 1))
        px = np.clip((px + (1 << 17)) >> 18, -128, 127) + 128
        out[lo:lo + step] = px.transpose(0, 2, 1)
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
        if len(body) != 6 + 3 * n:  # get_sof
            raise _Unsupported(f"a frame header of {n} components in "
                               f"{len(body) + 2} bytes")
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
        # each component's quantisation table as its first scan latched it
        self.quant: Dict[int, np.ndarray] = {}
        # libjpeg-turbo's coef_bits before each component's latest scan,
        # the scans read, and the last iMCU row begun with data left: block
        # smoothing takes the earlier bits past that row
        self.prev_coef_bits = np.zeros((n, 64), np.int64)
        self.scans = 0
        self.last_good = 0
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
        ns = body[0] if body else 0
        if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:  # get_sos
            raise _Unsupported(f"a scan header of {ns} components in "
                               f"{len(body) + 2} bytes")
        self.comps, self.td, self.ta = [], [], []
        for j in range(ns):
            cid, t = body[1 + 2 * j], body[2 + 2 * j]
            if cid not in frame.ids:
                raise _Unsupported(f"a scan naming component {cid}, not in "
                                   "its frame")
            ci = frame.ids.index(cid)
            if ci in self.comps:
                raise _Unsupported(f"a scan naming component {cid} twice")
            self.comps.append(ci)
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
    lo, hi = min(scan.ss, 1), max(scan.se, 9) + 1
    for ci in scan.comps:
        frame.prev_coef_bits[ci, lo:hi] = (frame.coef_bits[ci, lo:hi]
                                           if frame.scans > 1 else 0)
        frame.coef_bits[ci, scan.ss:scan.se + 1] = scan.al


def _next(out: np.ndarray, rc: int, err) -> Tuple[int, int]:
    if rc == -2:
        raise _Truncated(f"a JPEG that ends before its EOI ({err.value.decode()})")
    if rc != 0:
        raise _Unsupported(err.value.decode())
    return int(out[0]), int(out[1])


def _native_scan(frame: _Frame, scan: _Scan, tables: _Tables,
                 data: bytes, pos: int) -> Tuple[int, int, int]:
    """One scan (``data[pos:]``: its bytes to the end of the file) through
    the C++ entropy stage: ``(index past the marker after it, that marker's
    code, the last byte an arithmetic decoder reads)`` (-1: the file ends
    first; none, or a Huffman scan)."""
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
        t = tc * 4 + th
        huff[t, :16] = np.frombuffer(counts, np.uint8)
        huff[t, 16:16 + len(symbols)] = np.frombuffer(symbols, np.uint8)
        present |= 1 << t
    cond = np.array(tables.dc_l + tables.dc_u + tables.ac_k, np.int32)
    planes = (ctypes.c_void_p * ns)(*[frame.coef[ci].ctypes.data
                                      for ci in scan.comps])
    err = ctypes.create_string_buffer(256)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    out = np.zeros(4, np.int64)
    rc = _native().jpeg_scan(_ptr(buf), len(buf), _ptr(params), _ptr(geo),
                             ctypes.cast(planes, ctypes.c_void_p), _ptr(huff),
                             present, _ptr(cond), _ptr(out), err, len(err))
    if out[3] >= 0:
        frame.last_good = int(out[3])
    return (*_next(out, rc, err), int(out[2]))


def _lossless_scan(frame: _Frame, scan: _Scan, tables: _Tables,
                   data: bytes, pos: int) -> Tuple[int, int]:
    """One lossless scan through the C++ stage (``scan.ss`` is the
    predictor, ``scan.al`` the point transform; ``start_pass_lossless``'s
    checks first): the marker after it as ``_native_scan``'s."""
    if not 1 <= scan.ss <= 7 or scan.se or scan.ah or scan.al >= 8:
        raise _Unsupported("a lossless scan with Ss, Se, Ah, Al = "
                           f"{scan.ss}, {scan.se}, {scan.ah}, {scan.al}")
    ns = len(scan.comps)
    geo = np.zeros((ns, 5), np.int32)
    for j, ci in enumerate(scan.comps):
        geo[j] = (*frame.comp_size(ci), *frame.hv[ci], scan.td[j])
    params = np.array([ns, frame.mcux, frame.mcuy, scan.ss, scan.al,
                       tables.restart, 8], np.int32)
    huff = np.zeros((4, 272), np.uint8)
    present = 0
    for (tc, th), (counts, symbols) in tables.huff.items():
        if tc == 0:
            huff[th, :16] = np.frombuffer(counts, np.uint8)
            huff[th, 16:16 + len(symbols)] = np.frombuffer(symbols, np.uint8)
            present |= 1 << th
    out = (ctypes.c_void_p * ns)(*[frame.samples[ci].ctypes.data
                                   for ci in scan.comps])
    err = ctypes.create_string_buffer(256)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    nxt = np.zeros(2, np.int64)
    rc = _native().jpeg_lossless_scan(
        _ptr(buf), len(buf), _ptr(params), _ptr(geo),
        ctypes.cast(out, ctypes.c_void_p), _ptr(huff), present, _ptr(nxt),
        err, len(err))
    pos, code = _next(nxt, rc, err)
    for ci in scan.comps:
        frame.samples[ci] <<= scan.al
    return pos, code


def _next_marker(data: bytes, pos: int) -> Tuple[int, int]:
    """``next_marker`` from ``pos``: the next marker's code and the index
    past its code byte (data, stuffed zeros and fill bytes skipped)."""
    m = _MARKER.search(data, pos)
    if m is None:
        raise _Truncated("a JPEG that ends before its EOI")
    return data[m.end() - 1], m.end()


def _body(data: bytes, pos: int) -> bytes:
    """A marker segment's body (its length field first)."""
    if pos + 2 > len(data):
        raise _Truncated("a JPEG that ends before its EOI")
    n = int.from_bytes(data[pos:pos + 2], "big")
    if pos + max(n, 2) > len(data):
        raise _Truncated("a JPEG that ends before its EOI")
    return data[pos + 2:pos + n] if n >= 2 else None


def _decode(data: bytes, plain: bool = False, tables=None,
            finish_fails: bool = True):
    """Parse the markers and entropy-decode every scan as libjpeg's
    ``read_markers`` and ``consume_data`` do: ``(frame, tables, colour
    space)``.  ``plain`` decodes through ``_decode_scan`` (baseline Huffman
    only).  A file that ends where libjpeg waits for more raises, unless
    its one scan is done (Pillow has every row then).  ``tables``: the
    quantisation and Huffman tables in force before the SOI (libjpeg keeps
    them from one stream to the next of a decompressor; the SOI resets the
    rest).  ``finish_fails=False``: a fault past the rows of a one-scan
    frame is let be, as libtiff lets ``jpeg_finish_decompress``'s error
    pass (its ``CALLJPEG`` returns -1, which it takes for success)."""
    if data[:2] != b"\xff\xd8":
        raise _Unsupported("not a JPEG file (no SOI)")
    state = {"frame": None, "rows_out": False, "carry": tables}
    try:
        return _markers(data, plain, state)
    except _Truncated:
        frame = state["frame"]
        if not state["rows_out"]:
            raise
    except _Unsupported:
        frame = state["frame"]
        if finish_fails or not state["rows_out"]:
            raise
    if not all(frame.scanned):
        raise _Unsupported("a component without a scan")
    return frame, state["tables"], _colour_space(frame, state["adobe"],
                                                 state["jfif"])


def _markers(data: bytes, plain: bool, state: dict):
    pos, frame, marker = 2, None, None
    tables = state.get("carry") or _Tables()
    # get_soi: the arithmetic conditioning and the restart interval reset
    tables.dc_l, tables.dc_u, tables.ac_k = [0] * 16, [1] * 16, [5] * 16
    tables.restart = 0
    state.update(tables=tables, adobe=None, jfif=False)
    multi = None  # libjpeg's has_multiple_scans, set at the first SOS
    fed = _PILLOW_BLOCK  # the bytes Pillow has fed libjpeg so far

    def feed(end: int) -> None:
        """libjpeg reads (and may wait for) the bytes before ``end``."""
        nonlocal fed
        fed = max(fed, -(-end // _PILLOW_BLOCK) * _PILLOW_BLOCK)

    while True:
        if marker is None:
            marker, pos = _next_marker(data, pos)
        m, marker = marker, None
        if m == 0xD9:  # EOI
            break
        if m == 0xD8:
            raise _Unsupported("a second SOI")
        if 0xD0 <= m <= 0xD7 or m == 0x01:  # RSTn, TEM: no body
            continue
        if not (0xC0 <= m <= 0xCF or 0xDA <= m <= 0xDD or 0xE0 <= m <= 0xEF
                or m == 0xFE):
            raise _Unsupported(f"an unknown marker {m:#04x}")
        if 0xC0 <= m <= 0xCF and m not in _READ + (0xC4, 0xCC):
            raise _Unsupported(f"a {_SOF_KINDS.get(m, hex(m))} frame "
                               f"(SOF{m - 0xC0})")
        body = _body(data, pos)
        if m == 0xDA and (multi is False or frame is None):
            raise _Unsupported("a scan before its frame" if frame is None else
                               "a second scan in a single-scan frame")
        pos += 2 if body is None else 2 + len(body)
        feed(pos)
        if body is None:
            if m in (0xC4, 0xDB, 0xCC, 0xDD, 0xDA) or 0xC0 <= m <= 0xCF:
                raise _Unsupported(f"a marker {m:#04x} of a bad length")
            body = b""
        if m == 0xDB:  # DQT (get_dqt)
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                width = 2 if pq else 1
                vals = np.frombuffer(body[i + 1:i + 1 + 64 * width],
                                     ">u2" if pq else np.uint8)
                if len(vals) != 64 or tq > 3:
                    raise _Unsupported("a bad quantisation table")
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = vals
                tables.quant[tq] = q
                i += 1 + 64 * width
        elif m == 0xC4:  # DHT (get_dht)
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                n = sum(counts)
                if (len(counts) != 16 or n > 256 or n > len(body) - i - 17
                        or th > 3 or tc > 1):
                    raise _Unsupported("a bad Huffman table")
                tables.huff[(tc, th)] = (counts, body[i + 17:i + 17 + n])
                i += 17 + n
        elif m == 0xCC:  # DAC (get_dac)
            if len(body) % 2:
                raise _Unsupported("a DAC of a bad length")
            for i in range(0, len(body), 2):
                tc, tb, cs = body[i] >> 4, body[i] & 15, body[i + 1]
                if tc > 1:
                    raise _Unsupported(f"a DAC naming table {body[i]:#04x}")
                if tc == 0:
                    tables.dc_l[tb], tables.dc_u[tb] = cs & 15, cs >> 4
                    if tables.dc_l[tb] > tables.dc_u[tb]:
                        raise _Unsupported(f"a DAC with L > U ({cs:#x})")
                elif not 1 <= cs <= 63:
                    raise _Unsupported(f"a DAC with Kx = {cs}")
                else:
                    tables.ac_k[tb] = cs
        elif m == 0xDD:  # DRI
            if len(body) != 2:
                raise _Unsupported("a DRI of a bad length")
            tables.restart = int.from_bytes(body[:2], "big")
        elif m == 0xE0:
            state["jfif"] |= body[:5] == b"JFIF\0"
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            state["adobe"] = body[11]
        elif 0xE1 <= m <= 0xEF or m in (0xFE, 0xDC):  # APPn, COM, DNL
            pass
        elif 0xC0 <= m <= 0xCF and m not in (0xC4, 0xCC):
            if frame is not None:
                raise _Unsupported("more than one frame")
            frame = state["frame"] = _Frame(m, body)
        elif m == 0xDA:  # SOS
            scan = _Scan(frame, body)
            frame.scans += 1
            if multi is None:  # the first scan: missing tables 0, 1 default
                multi = (len(scan.comps) < len(frame.ids) or frame.progressive)
                for key, (counts, symbols) in _STD_HUFF.items():
                    tables.huff.setdefault(key, (bytes.fromhex(counts),
                                                 bytes.fromhex(symbols)))
            for ci in scan.comps:  # latch_quant_tables
                frame.scanned[ci] = True
                if not frame.lossless and ci not in frame.quant:
                    if frame.tq[ci] not in tables.quant:
                        raise _Unsupported(
                            f"component {ci} names a missing quantisation "
                            f"table {frame.tq[ci]}")
                    frame.quant[ci] = tables.quant[frame.tq[ci]].copy()
            if frame.lossless:
                nxt, code = _lossless_scan(frame, scan, tables, data, pos)
                last = -1
            else:
                if frame.progressive:
                    _check_progression(frame, scan)
                if plain:
                    if frame.progressive or frame.arith:
                        raise _Unsupported("the plain stage reads sequential "
                                           "Huffman scans only")
                    nxt, code = _decode_scan(frame, scan, tables, data[pos:])
                    last = -1
                else:
                    nxt, code, last = _native_scan(frame, scan, tables,
                                                   data, pos)
            if frame.arith and last >= 0 and last + pos >= fed:
                raise _Unsupported(
                    "an arithmetic-coded scan read past Pillow's first "
                    f"{fed:,} bytes: libjpeg-turbo's arithmetic decoder "
                    "cannot wait for Pillow's next 64 KiB block, and "
                    "Pillow raises 'broken data stream'")
            state["rows_out"] = not multi
            if nxt < 0:
                raise _Truncated("a JPEG that ends before its EOI")
            pos, marker = pos + nxt, code
            if not frame.arith:
                feed(pos)
    if frame is None:
        raise _Unsupported("no frame")
    if not all(frame.scanned):
        raise _Unsupported("a component without a scan")
    return frame, tables, _colour_space(frame, state["adobe"], state["jfif"])


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
        if ci not in quant or (quant[ci][_ZIGZAG[:10]] == 0).any():
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
        q = quant[ci].astype(np.int64)
        dc = plane[:, :, 0].astype(np.int64)
        win = _dc_window(dc, frame, ci)
        work = plane[:bh, :bw].astype(np.int64)
        # rows of iMCU rows past the last one begun with data take the bits
        # before the latest scan (decompress_smooth_data)
        late = np.arange(bh) // frame.hv[ci][1] > frame.last_good
        prev = (frame.prev_coef_bits[ci] if frame.scans > 1 else
                np.full(64, -1, np.int64))
        done = work.copy()
        for bits, rows in ((frame.coef_bits[ci], ~late), (prev, late)):
            if not rows.any():
                continue
            part = _smooth_blocks(work[rows], win[rows], bits, q)
            done[rows] = part
        plane[:bh, :bw] = done.astype(np.int16)
        out.append(plane.reshape(-1))
    return out


def _smooth_blocks(work: np.ndarray, win: np.ndarray, bits: np.ndarray,
                   q: np.ndarray) -> np.ndarray:
    """The estimates of ``work``'s zero coefficients (blocks, 64) from their
    5x5 DC windows, with one component's latched ``bits``."""
    work = work.copy()
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
    return work


def _pixels(frame: _Frame, tables: _Tables, space: str, plain: bool,
            seconds: dict):
    """The decoded frame as Pillow gives it: ``(array, mode)``; each
    stage's seconds added to ``seconds``."""
    planes = []
    clock = time.perf_counter
    coef = (_smooth(frame, frame.quant) if _smoothing_ok(frame, frame.quant)
            else frame.coef)

    def lap(stage, t0):
        seconds[stage] = seconds.get(stage, 0.0) + clock() - t0

    for ci in range(len(frame.ids)):
        cw, ch = frame.comp_size(ci)
        t0 = clock()
        if frame.lossless:
            plane = frame.samples[ci].astype(np.uint8)
        else:
            plane = _idct_plane(coef[ci], frame.quant[ci],
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
