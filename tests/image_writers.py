"""PNG and JPEG writers on numpy and zlib alone, for the image readers' tests
and ``chip_smoke.py`` (whose machine has no PIL and no encoder).

They write the layouts Pillow cannot write: PNG at every bit depth and
colour type (1/2/4/8/16-bit gray, 8/16-bit RGB, gray + alpha and RGBA,
1/2/4/8-bit palette), with ``tRNS`` and Adam7 interlacing; JPEG from given
quantised coefficients as sequential or progressive Huffman (any scan
script), sequential or progressive arithmetic coding (T.81 Annex D's QM
coder, as libjpeg's ``jcarith.c``, with DAC conditioning), lossless (SOF3,
predictors 1-7, point transform), at any sampling factors, 1, 3 or 4
components, with or without JFIF and Adobe markers and restart intervals.
The Huffman tables are flat: every symbol used gets a code of the same
length.  Nothing here is part of the port.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ------------------------------------------------------------------ PNG
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _pack_rows(img: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, row bytes) uint8, big-endian, MSB first."""
    h, w, c = img.shape
    if depth == 16:
        return img.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return img.astype(np.uint8).reshape(h, w * c)
    per = 8 // depth
    flat = img.reshape(h, w * c).astype(np.uint8)
    pad = (-flat.shape[1]) % per
    flat = np.concatenate([flat, np.zeros((h, pad), np.uint8)], 1)
    flat = flat.reshape(h, -1, per)
    out = np.zeros(flat.shape[:2], np.uint8)
    for i in range(per):
        out |= flat[:, :, i] << (8 - depth * (i + 1))
    return out


def _filter_rows(rows: np.ndarray, bpp: int, ftypes: Sequence[int]) -> bytes:
    """Each row behind its filter byte, filtered with ``ftypes[y]``."""
    out = []
    a = rows.astype(np.int32)
    for y in range(a.shape[0]):
        up = a[y - 1] if y else np.zeros(a.shape[1], np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), a[y, :-bpp]])[:a.shape[1]]
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])[:a.shape[1]]
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        f = ftypes[y % len(ftypes)]
        pred = [np.zeros_like(left), left, up, (left + up) >> 1, paeth][f]
        out.append(bytes([f]) + ((a[y] - pred) & 0xFF).astype(np.uint8).tobytes())
    return b"".join(out)


def png_bytes(img: np.ndarray, depth: int, ctype: int,
              palette: Optional[np.ndarray] = None, trns: Optional[bytes] = None,
              interlace: bool = False, ftypes: Sequence[int] = (0, 1, 2, 3, 4)
              ) -> bytes:
    """A PNG of ``img`` ((h, w) or (h, w, c) samples, each below 2^depth;
    palette indices for colour type 3), ``palette`` (n, 3) uint8, ``trns``
    the raw tRNS body; rows filtered in turn with ``ftypes``."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c != _PNG_CHANNELS[ctype]:
        raise ValueError(f"colour type {ctype} takes {_PNG_CHANNELS[ctype]} "
                         f"channels, not {c}")
    if img.max(initial=0) >= 1 << depth:
        raise ValueError(f"a sample above {depth} bits")
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = []
        for x0, y0, dx, dy in _ADAM7:
            sub = img[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                raw.append(_filter_rows(_pack_rows(sub, depth), bpp, ftypes))
        raw = b"".join(raw)
    else:
        raw = _filter_rows(_pack_rows(img, depth), bpp, ftypes)
    body = _PNG_SIG + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        body += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    # the image data in two IDAT chunks
    z = zlib.compress(raw, 6)
    cut = len(z) // 2
    return body + _chunk(b"IDAT", z[:cut]) + _chunk(b"IDAT", z[cut:]) + _chunk(
        b"IEND", b"")


# ----------------------------------------------------------------- JPEG
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
# T.81 Annex K's example tables, natural order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)


def _quant_table(quality: int, chroma: bool = False) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` of the Annex K tables, natural
    order, in [1, 255]."""
    q = max(1, min(100, quality))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    base = _CHROMA_Q if chroma else _LUMA_Q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


_DCT = np.array([[(np.sqrt(0.125) if u == 0 else 0.5)
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


class Frame:
    """A JPEG frame's geometry and its quantised coefficients: ``coef[ci]``
    (nby, nbx, 64) int natural order over the MCU-padded block grid."""

    def __init__(self, w: int, h: int, sampling: Sequence[Tuple[int, int]],
                 quant: Sequence[np.ndarray], tq: Sequence[int],
                 coef: Sequence[np.ndarray], ids: Sequence[int]):
        self.w, self.h, self.hv = w, h, list(sampling)
        self.quant, self.tq, self.coef = list(quant), list(tq), list(coef)
        self.ids = list(ids)
        self.hmax = max(a for a, _ in self.hv)
        self.vmax = max(b for _, b in self.hv)
        self.mcux = -(-w // (8 * self.hmax))
        self.mcuy = -(-h // (8 * self.vmax))
        # each block's coefficients in zigzag order, as Python ints
        self.zz = [np.asarray(c)[..., ZIGZAG].tolist() for c in self.coef]

    def comp_blocks(self, ci: int) -> Tuple[int, int]:
        h, v = self.hv[ci]
        cw = -(-self.w * h // self.hmax)
        ch = -(-self.h * v // self.vmax)
        return -(-cw // 8), -(-ch // 8)


def rgb_to_ycc(rgb: np.ndarray) -> List[np.ndarray]:
    """JFIF's RGB -> YCbCr, float."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    return [y, cb, cr]


def frame_from_planes(planes: Sequence[np.ndarray],
                      sampling: Sequence[Tuple[int, int]], quality: int = 90,
                      ids: Optional[Sequence[int]] = None) -> Frame:
    """Quantised DCT coefficients of full-size sample planes (floats in
    [0, 255]), each box-averaged down to its sampling factors; component 0
    uses the luma table, the rest the chroma one."""
    h, w = planes[0].shape
    hmax = max(a for a, _ in sampling)
    vmax = max(b for _, b in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    quant = [_quant_table(quality), _quant_table(quality, chroma=True)]
    coefs, tq = [], []
    for ci, (plane, (hs, vs)) in enumerate(zip(planes, sampling)):
        fx, fy = hmax // hs, vmax // vs
        # pad to whole MCUs by edge replication, then box-average
        full = np.pad(np.asarray(plane, np.float64),
                      ((0, mcuy * vmax * 8 - h), (0, mcux * hmax * 8 - w)),
                      mode="edge")
        if hmax % hs or vmax % vs:  # fractional: nearest samples
            ys = (np.arange(mcuy * vs * 8) * vmax) // vs
            xs = (np.arange(mcux * hs * 8) * hmax) // hs
            small = full[ys][:, xs]
        else:
            small = full.reshape(full.shape[0] // fy, fy, full.shape[1] // fx,
                                 fx).mean((1, 3))
        nby, nbx = small.shape[0] // 8, small.shape[1] // 8
        blocks = (small - 128).reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)
        dct = np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT)
        t = 0 if ci == 0 else 1
        q = quant[t].reshape(8, 8)
        coefs.append(np.round(dct / q).astype(np.int64).reshape(nby, nbx, 64))
        tq.append(t)
    if ids is None:
        ids = list(range(1, len(planes) + 1))
    return Frame(w, h, sampling, quant, tq, coefs, ids)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, nbits: int):
        if nbits == 0:
            return
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with ones
        data = bytes(self.out)
        self.out = bytearray()
        return data


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def _bits_of(v: int, s: int) -> int:
    return v if v >= 0 else v + (1 << s) - 1


class _Symbols:
    """A scan's Huffman symbol stream: ``(table, symbol, bits, nbits)``
    items, ``table`` None for raw bits, and ``("RST", n)`` markers."""

    def __init__(self):
        self.items: List[tuple] = []

    def sym(self, table, symbol: int, bits: int = 0, nbits: int = 0):
        self.items.append((table, symbol, bits, nbits))

    def raw(self, bits: int, nbits: int):
        self.items.append((None, 0, bits, nbits))

    def restart(self, n: int):
        self.items.append(("RST", n, 0, 0))


def _flat_table(symbols) -> Tuple[bytes, bytes, Dict[int, Tuple[int, int]]]:
    """Counts, symbols and the code of each: every used symbol one code of
    the same length, the all-ones code left out."""
    syms = sorted(set(symbols)) or [0]
    L = max(1, (len(syms)).bit_length())
    if len(syms) >= 1 << L:
        L += 1
    counts = [0] * 16
    counts[L - 1] = len(syms)
    codes = {s: (i, L) for i, s in enumerate(syms)}
    return bytes(counts), bytes(syms), codes


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _blocks_of_scan(frame: Frame, comps: Sequence[int]):
    """The scan's MCUs, each a list of ``(scan index, block in zigzag
    order)``."""
    if len(comps) == 1:
        ci = comps[0]
        bw, bh = frame.comp_blocks(ci)
        for by in range(bh):
            for bx in range(bw):
                yield [(0, frame.zz[ci][by][bx])]
        return
    for my in range(frame.mcuy):
        for mx in range(frame.mcux):
            unit = []
            for j, ci in enumerate(comps):
                hs, vs = frame.hv[ci]
                for yy in range(vs):
                    for xx in range(hs):
                        unit.append((j, frame.zz[ci][my * vs + yy][mx * hs + xx]))
            yield unit


def _huffman_scan(frame: Frame, comps, ss, se, ah, al, restart,
                  progressive: bool) -> _Symbols:
    out = _Symbols()
    pred = [0] * len(comps)
    eobrun, be = 0, []  # pending EOB run and its correction bits

    def emit_eobrun():
        nonlocal eobrun, be
        if eobrun:
            nb = eobrun.bit_length() - 1
            out.sym(("ac", 0), nb << 4, eobrun & ((1 << nb) - 1), nb)
            eobrun = 0
        for b in be:
            out.raw(b, 1)
        be = []

    for n, unit in enumerate(_blocks_of_scan(frame, comps)):
        if restart and n and n % restart == 0:
            emit_eobrun()
            out.restart(n // restart - 1)
            pred = [0] * len(comps)
        for j, zz in unit:
            if not progressive or ss == 0:
                if progressive and ah:
                    out.raw((zz[0] >> al) & 1, 1)
                else:
                    dc = zz[0] >> al if progressive else zz[0]
                    diff = dc - pred[j]
                    pred[j] = dc
                    s = _category(diff)
                    out.sym(("dc", j), s, _bits_of(diff, s), s)
                if progressive:
                    continue
            lo, hi = (1, 63) if not progressive else (ss, se)
            if not progressive:
                r = 0
                for k in range(1, 64):
                    v = zz[k]
                    if v == 0:
                        r += 1
                        continue
                    while r > 15:
                        out.sym(("ac", j), 0xF0)
                        r -= 16
                    s = _category(v)
                    out.sym(("ac", j), (r << 4) | s, _bits_of(v, s), s)
                    r = 0
                if r:
                    out.sym(("ac", j), 0)
            elif ah == 0:  # AC first
                r = 0
                for k in range(lo, hi + 1):
                    v = zz[k]
                    t = (-v) >> al if v < 0 else v >> al
                    if t == 0:
                        r += 1
                        continue
                    emit_eobrun()
                    while r > 15:
                        out.sym(("ac", 0), 0xF0)
                        r -= 16
                    s = _category(t)
                    out.sym(("ac", 0), (r << 4) | s, t if v > 0 else ~t, s)
                    r = 0
                if r:
                    eobrun += 1
                    if eobrun == 0x7FFF:
                        emit_eobrun()
            else:  # AC refine (jcphuff.c encode_mcu_AC_refine)
                absv = [abs(zz[k]) >> al for k in range(64)]
                eob = 0
                for k in range(lo, hi + 1):
                    if absv[k] == 1:
                        eob = k
                r, br = 0, []
                for k in range(lo, hi + 1):
                    t = absv[k]
                    if t == 0:
                        r += 1
                        continue
                    while r > 15 and k <= eob:
                        emit_eobrun()
                        out.sym(("ac", 0), 0xF0)
                        r -= 16
                        for b in br:
                            out.raw(b, 1)
                        br = []
                    if t > 1:
                        br.append(t & 1)
                        continue
                    emit_eobrun()
                    out.sym(("ac", 0), (r << 4) | 1)
                    out.raw(0 if zz[k] < 0 else 1, 1)
                    for b in br:
                        out.raw(b, 1)
                    br = []
                    r = 0
                if r > 0 or br:
                    eobrun += 1
                    be += br
                    if eobrun == 0x7FFF or len(be) > 937:
                        emit_eobrun()
    emit_eobrun()
    return out


# T.81 Table D.2 (Qe, Next_LPS, Next_MPS, Switch_MPS); entry 113 is the
# fixed 0.5 estimate
_QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


class _QM:
    """The QM encoder of ``jcarith.c`` (T.81 D.1), with its carry and 0xFF
    stacking; a statistics bin is one int: index | MPS << 7."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b: int):
        self.out.append(b)

    def _flush_pending(self, byte: int):
        if self.zc:
            self.out.extend(b"\0" * self.zc)
            self.zc = 0
        self._emit(byte)

    def encode(self, bins: list, i: int, val: int):
        sv = bins[i]
        qe, nl, nm, sw = _QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the LPS
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ (nl | (sw << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) | nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_pending(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_pending(self.buffer)
                    if self.sc:
                        if self.zc:
                            self.out.extend(b"\0" * self.zc)
                            self.zc = 0
                        self.out.extend(b"\xff\x00" * self.sc)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_pending(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_pending(self.buffer)
            if self.sc:
                if self.zc:
                    self.out.extend(b"\0" * self.zc)
                    self.zc = 0
                self.out.extend(b"\xff\x00" * self.sc)
                self.sc = 0
        if self.c & 0x7FFF800:
            if self.zc:
                self.out.extend(b"\0" * self.zc)
                self.zc = 0
            b = (self.c >> 19) & 0xFF
            self._emit(b)
            if b == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)
        return bytes(self.out)


class _ArithScan:
    """One arithmetic-coded scan (``jcarith.c``'s encode_mcu procedures)."""

    def __init__(self, ss, se, ah, al, ncomp, dc_l, dc_u, ac_k, progressive):
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.progressive = progressive
        self.dc_l, self.dc_u, self.ac_k = dc_l, dc_u, ac_k
        self.ncomp = ncomp
        self.reset()

    def reset(self):
        self.qm = _QM()
        self.dc_stats = [[0] * 64 for _ in range(self.ncomp)]
        self.ac_stats = [[0] * 256 for _ in range(self.ncomp)]
        self.fixed = [113]
        self.last = [0] * self.ncomp
        self.ctx = [0] * self.ncomp

    def _magnitude(self, stats, st, v, ac_k=None, k=0):
        """Figures F.8 and F.9 for ``v = |value| - 1`` from bin ``st``."""
        qm = self.qm
        m = 0
        if v:
            qm.encode(stats, st, 1)
            m = 1
            v2 = v
            if ac_k is None:
                st = 20
                v2 >>= 1
                while v2:
                    qm.encode(stats, st, 1)
                    m <<= 1
                    st += 1
                    v2 >>= 1
            else:
                v2 >>= 1
                if v2:
                    qm.encode(stats, st, 1)
                    m <<= 1
                    st = 189 if k <= ac_k else 217
                    v2 >>= 1
                    while v2:
                        qm.encode(stats, st, 1)
                        m <<= 1
                        st += 1
                        v2 >>= 1
        qm.encode(stats, st, 0)
        st += 14
        m >>= 1
        while m:
            qm.encode(stats, st, 1 if m & v else 0)
            m >>= 1
        return

    def dc(self, j, value):
        stats = self.dc_stats[j]
        st = self.ctx[j]
        diff = value - self.last[j]
        qm = self.qm
        if diff == 0:
            qm.encode(stats, st, 0)
            self.ctx[j] = 0
            return
        self.last[j] = value
        qm.encode(stats, st, 1)
        if diff > 0:
            qm.encode(stats, st + 1, 0)
            st += 2
            self.ctx[j] = 4
            v = diff
        else:
            qm.encode(stats, st + 1, 1)
            st += 3
            self.ctx[j] = 8
            v = -diff
        v -= 1
        m = 0 if v == 0 else 1 << (v.bit_length() - 1)
        if m < (1 << self.dc_l[j]) >> 1:
            self.ctx[j] = 0
        elif m > (1 << self.dc_u[j]) >> 1:
            self.ctx[j] += 8
        self._magnitude(stats, st, v)

    def ac(self, j, zz):
        """AC coefficients ``zz[ss..se]`` (sequential: 1..63), first pass."""
        stats, qm, al = self.ac_stats[j], self.qm, self.al
        lo, hi = (self.ss, self.se) if self.progressive else (1, 63)
        t = [((-v) >> al) if v < 0 else (v >> al) for v in zz]
        ke = hi
        while ke >= lo and t[ke] == 0:
            ke -= 1
        k = lo
        while k <= ke:
            st = 3 * (k - 1)
            qm.encode(stats, st, 0)
            while t[k] == 0:
                qm.encode(stats, st + 1, 0)
                st += 3
                k += 1
            qm.encode(stats, st + 1, 1)
            qm.encode(self.fixed, 0, 1 if zz[k] < 0 else 0)
            self._magnitude(stats, st + 2, t[k] - 1, ac_k=self.ac_k[j], k=k)
            k += 1
        if k <= hi:
            qm.encode(stats, 3 * (k - 1), 1)

    def ac_refine(self, j, zz):
        stats, qm, al, ah = self.ac_stats[j], self.qm, self.al, self.ah
        t = [abs(v) >> al for v in zz]
        ke = self.se
        while ke > 0 and t[ke] == 0:
            ke -= 1
        kex = ke
        while kex > 0 and (abs(zz[kex]) >> ah) == 0:
            kex -= 1
        k = self.ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                qm.encode(stats, st, 0)
            while True:
                if t[k]:
                    if t[k] >> 1:
                        qm.encode(stats, st + 2, t[k] & 1)
                    else:
                        qm.encode(stats, st + 1, 1)
                        qm.encode(self.fixed, 0, 1 if zz[k] < 0 else 0)
                    break
                qm.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= self.se:
            qm.encode(stats, 3 * (k - 1), 1)


def _arith_scan(frame: Frame, comps, ss, se, ah, al, restart, progressive,
                dc_l, dc_u, ac_k) -> List[bytes]:
    """The scan's entropy-coded segments, one a restart interval."""
    coder = _ArithScan(ss, se, ah, al, len(comps), dc_l, dc_u, ac_k,
                       progressive)
    segments = []
    for n, unit in enumerate(_blocks_of_scan(frame, comps)):
        if restart and n and n % restart == 0:
            segments.append(coder.qm.finish())
            coder.reset()
        for j, zz in unit:
            if not progressive:
                coder.dc(j, zz[0])
                coder.ac(j, zz)
            elif ss == 0 and ah == 0:
                coder.dc(j, zz[0] >> al)
            elif ss == 0:
                coder.qm.encode(coder.fixed, 0, (zz[0] >> al) & 1)
            elif ah == 0:
                coder.ac(j, zz)
            else:
                coder.ac_refine(j, zz)
    segments.append(coder.qm.finish())
    return segments


# libjpeg's jpeg_simple_progression for 3 components (and its gray script)
_SIMPLE_PROGRESSION_3 = [
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0)]
_SIMPLE_PROGRESSION_1 = [
    ((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
    ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def progression(ncomp: int, kind: str = "simple"):
    """A scan script: ``simple`` (libjpeg's, generalised to any count of
    components: successive approximation with Al up to 2), ``spectral``
    (spectral selection only, each component's DC on its own)."""
    if kind == "simple":
        if ncomp == 3:
            return _SIMPLE_PROGRESSION_3
        if ncomp == 1:
            return _SIMPLE_PROGRESSION_1
        allc = tuple(range(ncomp))
        script = [(allc, 0, 0, 0, 1)]
        script += [((c,), 1, 5, 0, 2) for c in range(ncomp)]
        script += [((c,), 6, 63, 0, 2) for c in range(ncomp)]
        script += [((c,), 1, 63, 2, 1) for c in range(ncomp)]
        script += [(allc, 0, 0, 1, 0)]
        script += [((c,), 1, 63, 1, 0) for c in range(ncomp)]
        return script
    script = [((c,), 0, 0, 0, 0) for c in range(ncomp)]
    for c in range(ncomp):
        script += [((c,), 1, 2, 0, 0), ((c,), 3, 20, 0, 0),
                   ((c,), 21, 63, 0, 0)]
    return script


def jpeg_bytes(frame: Frame, coding: str = "huffman", progressive: bool = False,
               script=None, restart: int = 0, jfif: bool = True,
               adobe: Optional[int] = None, dac: Optional[dict] = None,
               repeat: int = 1) -> bytes:
    """The frame's coefficients as a JPEG: ``coding`` ``huffman`` or
    ``arith``, sequential (one interleaved scan) or progressive along
    ``script`` (``(components, Ss, Se, Ah, Al)`` items; default
    ``progression(n)``); ``dac`` ``{"dc_l", "dc_u", "ac_k"}`` lists of the
    conditioning written in a DAC segment (default T.81's).

    ``repeat`` > 1 stacks the frame (whole MCU rows tall) ``repeat`` times
    vertically: each scan's restart interval is set (DRI) to the frame's
    units in that scan, so each copy is one restart interval and its
    entropy-coded bytes are the frame's, written once and repeated."""
    ncomp = len(frame.coef)
    arith = coding == "arith"
    sof = (0xCA if progressive else 0xC9) if arith else (0xC2 if progressive else 0xC0)
    out = [b"\xff\xd8"]
    if jfif:
        out.append(_segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0"))
    if adobe is not None:
        out.append(_segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                         adobe)))
    for t in sorted(set(frame.tq)):
        q = np.asarray(frame.quant[t])[ZIGZAG]
        out.append(_segment(0xDB, bytes([t]) + q.astype(np.uint8).tobytes()))
    if repeat > 1 and frame.h % (8 * frame.vmax):
        raise ValueError("a repeated frame must be whole MCU rows tall")
    body = struct.pack(">BHHB", 8, frame.h * repeat, frame.w, ncomp)
    for ci in range(ncomp):
        hs, vs = frame.hv[ci]
        body += bytes([frame.ids[ci], hs << 4 | vs, frame.tq[ci]])
    out.append(_segment(sof, body))
    dac = dac or {}
    dc_l = dac.get("dc_l", [0] * 4)
    dc_u = dac.get("dc_u", [1] * 4)
    ac_k = dac.get("ac_k", [5] * 4)
    if arith and dac:
        body = b""
        for t in range(min(ncomp, 4)):
            body += bytes([t, dc_u[t] << 4 | dc_l[t], 0x10 | t, ac_k[t]])
        out.append(_segment(0xCC, body))
    if restart and repeat == 1:
        out.append(_segment(0xDD, struct.pack(">H", restart)))
    if progressive:
        script = script or progression(ncomp)
    else:
        script = [(tuple(range(ncomp)), 0, 63, 0, 0)]
    def copies(segment: bytes) -> List[bytes]:
        """The scan's data: the frame's one interval, ``repeat`` times."""
        parts = [segment]
        for i in range(1, repeat):
            parts += [bytes([0xFF, 0xD0 + (i - 1) % 8]), segment]
        return parts

    for comps, ss, se, ah, al in script:
        comps = list(comps)
        if repeat > 1:
            units = (frame.comp_blocks(comps[0])[0] * frame.comp_blocks(comps[0])[1]
                     if len(comps) == 1 else frame.mcux * frame.mcuy)
            out.append(_segment(0xDD, struct.pack(">H", units)))
            restart = 0
        # every component of the scan uses its own table number (scan index)
        sos = bytes([len(comps)])
        for j, ci in enumerate(comps):
            sos += bytes([frame.ids[ci], j << 4 | j])
        sos += bytes([ss, se, ah << 4 | al])
        if arith:
            segs = _arith_scan(frame, comps, ss, se, ah, al, restart,
                               progressive, dc_l, dc_u, ac_k)
            out.append(_segment(0xDA, sos))
            if repeat > 1:
                out += copies(segs[0])
                continue
            for i, seg in enumerate(segs):
                if i:
                    out.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
                out.append(seg)
            continue
        syms = _huffman_scan(frame, comps, ss, se, ah, al, restart, progressive)
        used: Dict[tuple, set] = {}
        for table, symbol, _, _ in syms.items:
            if table is not None and table != "RST":
                used.setdefault(table, set()).add(symbol)
        codes = {}
        dht = b""
        for (kind, j), symbols in sorted(used.items()):
            counts, values, codes[(kind, j)] = _flat_table(symbols)
            dht += bytes([(kind == "ac") << 4 | j]) + counts + values
        if dht:
            out.append(_segment(0xC4, dht))
        out.append(_segment(0xDA, sos))
        bw = _BitWriter()
        for table, symbol, bits, nbits in syms.items:
            if table == "RST":
                out.append(bw.flush())
                out.append(bytes([0xFF, 0xD0 + symbol % 8]))
                continue
            if table is not None:
                code, length = codes[table][symbol]
                bw.put(code, length)
            bw.put(bits, nbits)
        out += copies(bw.flush())
    out.append(b"\xff\xd9")
    return b"".join(out)


def lossless_bytes(planes: Sequence[np.ndarray], predictor: int = 1,
                   pt: int = 0, restart_rows: int = 0, jfif: bool = False,
                   adobe: Optional[int] = None,
                   ids: Optional[Sequence[int]] = None,
                   sampling: Optional[Sequence[Tuple[int, int]]] = None
                   ) -> bytes:
    """A lossless JPEG (SOF3, one interleaved scan) of equal-size uint8
    planes, each taken down to its ``sampling`` factors (every 2nd, 3rd...
    sample); ``restart_rows`` MCU rows a restart interval."""
    ncomp = len(planes)
    sampling = list(sampling or [(1, 1)] * ncomp)
    ids = list(ids or range(1, ncomp + 1))
    h, w = planes[0].shape
    hmax = max(a for a, _ in sampling)
    vmax = max(b for _, b in sampling)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    restart = restart_rows * (mcux if ncomp > 1 else w)
    one = 1 << (8 - pt - 1)
    vals = []
    for p, (hs, vs) in zip(planes, sampling):
        cw, ch = -(-w * hs // hmax), -(-h * vs // vmax)
        sub = np.asarray(p, np.int64)[::vmax // vs, ::hmax // hs][:ch, :cw]
        vals.append(sub >> pt)
    syms = _Symbols()

    def predict(p, y, x, first_row):
        if y == first_row:
            return one if x == 0 else p[y, x - 1]
        if x == 0:
            return p[y - 1, x]
        ra, rb, rc = p[y, x - 1], p[y - 1, x], p[y - 1, x - 1]
        return [None, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                rb + ((ra - rc) >> 1), (ra + rb) >> 1][predictor]

    first = [0] * ncomp
    if ncomp == 1:
        units = [(y, x) for y in range(h) for x in range(w)]
    else:
        units = [(my, mx) for my in range(mcuy) for mx in range(mcux)]
    for n, (uy, ux) in enumerate(units):
        if restart and n and n % restart == 0:
            syms.restart(n // restart - 1)
        fresh = restart and n % restart == 0
        for j in range(ncomp):
            p = vals[j]
            hs, vs = (1, 1) if ncomp == 1 else sampling[j]
            y0, x0 = uy * vs, ux * hs
            if fresh or n == 0:
                first[j] = y0
            for yy in range(vs):
                for xx in range(hs):
                    y, x = y0 + yy, x0 + xx
                    if y < p.shape[0] and x < p.shape[1]:
                        diff = int(p[y, x] - predict(p, y, x, first[j]))
                    else:  # MCU padding: decoded and dropped
                        diff = 0
                    diff = ((diff + 32768) & 0xFFFF) - 32768
                    s = _category(diff)
                    if s == 16:
                        syms.sym(("dc", j), 16)
                    else:
                        syms.sym(("dc", j), s, _bits_of(diff, s), s)
    out = [b"\xff\xd8"]
    if jfif:
        out.append(_segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0"))
    if adobe is not None:
        out.append(_segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                         adobe)))
    body = struct.pack(">BHHB", 8, h, w, ncomp)
    for j in range(ncomp):
        body += bytes([ids[j], sampling[j][0] << 4 | sampling[j][1], 0])
    out.append(_segment(0xC3, body))
    if restart:
        out.append(_segment(0xDD, struct.pack(">H", restart)))
    used: Dict[tuple, set] = {}
    for table, symbol, _, _ in syms.items:
        if table is not None and table != "RST":
            used.setdefault(table, set()).add(symbol)
    codes, dht = {}, b""
    for (kind, j), symbols in sorted(used.items()):
        counts, values, codes[(kind, j)] = _flat_table(symbols)
        dht += bytes([j]) + counts + values
    out.append(_segment(0xC4, dht))
    sos = bytes([ncomp]) + b"".join(bytes([ids[j], j << 4]) for j in range(ncomp))
    out.append(_segment(0xDA, sos + bytes([predictor, 0, pt])))
    bw = _BitWriter()
    for table, symbol, bits, nbits in syms.items:
        if table == "RST":
            out.append(bw.flush())
            out.append(bytes([0xFF, 0xD0 + symbol % 8]))
            continue
        code, length = codes[table][symbol]
        bw.put(code, length)
        bw.put(bits, nbits)
    out.append(bw.flush())
    out.append(b"\xff\xd9")
    return b"".join(out)


# -------------------------------------------------------- scene rewrites
def palette_of(img: np.ndarray):
    """(indices, palette (n, 3), tRNS bytes or None) of an RGB or RGBA
    uint8 image of at most 256 colours."""
    h, w, c = img.shape
    colours, idx = np.unique(img.reshape(-1, c), axis=0, return_inverse=True)
    if len(colours) > 256:
        raise ValueError(f"{len(colours)} colours do not fit a palette")
    trns = bytes(colours[:, 3].tolist()) if c == 4 else None
    return idx.reshape(h, w), colours[:, :3], trns


def layout_bytes(img: np.ndarray, layout: str, seed: int = 0) -> bytes:
    """The 8-bit RGB or RGBA image ``img`` as a PNG in another layout of
    the same 8-bit values: ``rgba16`` / ``rgb16`` (each value the high byte,
    a random low byte), ``palette`` (palette + tRNS), ``palette-adam7`` or
    ``adam7``."""
    rng = np.random.RandomState(seed)
    ctype = {3: 2, 4: 6}[img.shape[2]]
    if layout in ("rgba16", "rgb16"):
        wide = img.astype(np.uint16) * 256 + rng.randint(0, 256, img.shape)
        return png_bytes(wide, 16, ctype)
    if layout.startswith("palette"):
        idx, pal, trns = palette_of(img)
        return png_bytes(idx, 8, 3, palette=pal, trns=trns,
                         interlace=layout.endswith("adam7"))
    return png_bytes(img, 8, ctype, interlace=True)


def png_as(path: str, out: str, layout: str, seed: int = 0) -> None:
    """Rewrite the 8-bit PNG ``path`` as ``out`` in ``layout``
    (``layout_bytes``), read with Pillow."""
    from PIL import Image

    data = layout_bytes(np.asarray(Image.open(path)), layout, seed)
    with open(out, "wb") as f:
        f.write(data)
