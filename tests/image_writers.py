"""Image writers on numpy, zlib and lzma alone, for the image readers' tests
and ``chip_smoke.py`` (whose machine has no PIL and no encoder).

TIFF (every layout, LZW in both styles, PackBits, predictors, strips,
tiles, planes, BigTIFF, fill order 2), WebP (VP8L literals after any
transform, ``ALPH``, a VP8 frame of random modes and small coefficients
through a boolean encoder, the RIFF container with ``VP8X``/``ANMF``),
PPM, BMP (RLE too) and GIF (LZW), then TGA (raw and run-length, colour
maps, both orientations and right-to-left), SGI (raw and run-length, 1 and
2 bytes a sample), PCX (every bits x planes layout), QOI (every op), PSD
(raw and PackBits), ICO and CUR (DIB and PNG payloads, AND masks) and DDS
(the header, the bitmask layouts, a BC7 mode-6 encoder) are written below
the PNG and JPEG writers, and last JPEG 2000 rewrites of an encoder's
files (boxes, SIZ, COD, SOP markers, tile-parts cut at PLT's packet
lengths, a one-tile codestream repeated over a grid).  Those write the layouts Pillow cannot write: PNG at every bit
depth and colour type (1/2/4/8/16-bit gray, 8/16-bit RGB, gray + alpha and RGBA,
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


# ================================================================= TIFF
_TIFF_TYPES = {"B": 1, "A": 2, "H": 3, "I": 4, "R": 5, "U": 7, "Q": 16}


def _reverse_bits(data: bytes) -> bytes:
    table = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    return data.translate(table)


def lzw_tiff(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW (libtiff's tif_lzw.c encoder): Clear first, codes 9-12 bits
    first bit first, widening one code early, Clear when the table fills,
    EOI last.  ``old_style``: the pre-5.0 variant (lowest bit first,
    widening at 512/1024/2048) libtiff still decodes."""
    acc, nacc, out = 0, 0, bytearray()

    def put(code, width):
        nonlocal acc, nacc
        if old_style:
            acc |= code << nacc
            nacc += width
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << width) | code
            nacc += width
            while nacc >= 8:
                nacc -= 8
                out.append((acc >> nacc) & 0xFF)
            acc &= (1 << nacc) - 1

    def grow(nxt, width):
        limit = (1 << width) + (1 if old_style else 0)
        return width + 1 if nxt >= limit and width < 12 else width

    width, nxt, table, w = 9, 258, {}, b""
    put(256, width)
    for c in data:
        wc = w + bytes([c])
        if not w or wc in table:
            w = wc
            continue
        put(table[w] if len(w) > 1 else w[0], width)
        table[wc] = nxt
        nxt += 1
        width = grow(nxt, width)
        if nxt >= 4093:
            put(256, width)
            width, nxt, table = 9, 258, {}
        w = bytes([c])
    if w:
        put(table[w] if len(w) > 1 else w[0], width)
        nxt += 1
        width = grow(nxt, width)
    put(257, width)
    if nacc:
        put(0, 8 - nacc)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits runs: repeats of 2-128 bytes and literals of 1-128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


class _FaxBits:
    """Bits first bit first (MSB first in each byte)."""

    def __init__(self):
        self.bits: List[str] = []
        self.n = 0

    def put(self, code: str) -> None:
        self.bits.append(code)
        self.n += len(code)

    def align(self) -> None:
        self.put("0" * (-self.n % 8))

    def data(self) -> bytes:
        s = "".join(self.bits)
        s += "0" * (-len(s) % 8)
        return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


_FAX_CODES: Dict[bool, Dict[int, str]] = {}


def _fax_codes(white: bool) -> Dict[int, str]:
    if white not in _FAX_CODES:
        from nerf_pl_tpu_torch.data import ccitt
        _FAX_CODES[white] = dict(ccitt.codes(white))
    return _FAX_CODES[white]


def _fax_run(bw: _FaxBits, run: int, white: bool) -> None:
    """A T.4 run: 2560 extended make-ups, a make-up, a terminating code."""
    codes = _fax_codes(white)
    while run > 2560:
        bw.put(codes[2560])
        run -= 2560
    if run >= 64:
        bw.put(codes[run // 64 * 64])
        run %= 64
    bw.put(codes[run])


def _changes(row: np.ndarray) -> List[int]:
    """Positions where a row of bits (0 white, 1 black) changes colour,
    starting from white, with the row's width twice at the end."""
    w = len(row)
    d = np.flatnonzero(np.diff(np.concatenate([[0], row.astype(np.int8)])))
    return d.tolist() + [w, w]


def _fax_1d(bw: _FaxBits, row: np.ndarray) -> None:
    ch = _changes(row)[:-1]
    x, white = 0, True
    for c in ch:
        _fax_run(bw, c - x, white)
        x, white = c, not white


def _fax_2d(bw: _FaxBits, row: np.ndarray, ref: np.ndarray) -> None:
    """T.4 4.2 / T.6: pass, horizontal and vertical modes against ``ref``."""
    w = len(row)
    a_ch, b_ch = _changes(row), _changes(ref)
    a0, colour = -1, 0  # 0 white
    ia = 0
    while a0 < w:
        # a1: the next change after a0; b1: the first change on the
        # reference row right of a0 of the colour opposite a0's
        while a_ch[ia] <= a0 and a_ch[ia] < w:
            ia += 1
        a1 = a_ch[ia]
        a2 = a_ch[ia + 1] if a1 < w else w
        ib = 0
        while b_ch[ib] <= a0 or ib % 2 != colour:
            if b_ch[ib] >= w:
                break
            ib += 1
        b1 = b_ch[ib]
        b2 = b_ch[ib + 1] if b1 < w else w
        if b2 < a1:
            bw.put("0001")
            a0 = b2
        elif abs(a1 - b1) <= 3:
            bw.put({0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010",
                    -2: "000010", -3: "0000010"}[a1 - b1])
            a0, colour = a1, 1 - colour
        else:
            bw.put("001")
            start = max(a0, 0)
            _fax_run(bw, a1 - start, colour == 0)
            _fax_run(bw, a2 - a1, colour == 1)
            a0 = a2


def fax_bytes(bits: np.ndarray, compression: int, options: int = 0,
              k: int = 4) -> bytes:
    """One strip of (rows, width) bits (0 white, 1 black) as CCITT
    compression 2 (Modified Huffman, rows byte-aligned), 3 (an EOL before
    each row; ``options`` bit 0: a tag bit after it and every ``k``-th row
    1-D, the others 2-D; bit 2: EOLs ending on a byte) or 4 (T.6 with an
    EOFB)."""
    bw = _FaxBits()
    ref = np.zeros(bits.shape[1], np.uint8)
    for i, row in enumerate(bits):
        if compression == 2:
            _fax_1d(bw, row)
            bw.align()
        elif compression == 3:
            if options & 4:
                bw.put("0" * (-(bw.n + 12) % 8))
            bw.put("000000000001")
            two_d = bool(options & 1) and i % k != 0
            if options & 1:
                bw.put("0" if two_d else "1")
            _fax_2d(bw, row, ref) if two_d else _fax_1d(bw, row)
        else:
            _fax_2d(bw, row, ref)
        ref = row
    if compression == 4:
        bw.put("000000000001" * 2)
    return bw.data()


def _tiff_rows(s: np.ndarray, bits: int, order: str, fmt: int) -> np.ndarray:
    """(rows, width, spp) samples -> (rows, row bytes) in the file's order."""
    rows, width, spp = s.shape
    e = "<" if order == "II" else ">"
    if bits in (1, 2, 4):
        flat = s.reshape(rows, width * spp).astype(np.uint8)
        bitsarr = ((flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1)
        return np.packbits(bitsarr.reshape(rows, -1).astype(np.uint8), axis=1)
    if bits == 8:
        return s.astype(np.uint8).reshape(rows, width * spp)
    if bits == 12:
        flat = s.reshape(rows, width * spp).astype(np.uint16)
        if flat.shape[1] % 2:
            flat = np.concatenate([flat, np.zeros((rows, 1), np.uint16)], 1)
        a, b = flat[:, 0::2], flat[:, 1::2]
        out = np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], -1)
        out = out.reshape(rows, -1).astype(np.uint8)
        return out[:, :(width * spp * 12 + 7) // 8]
    kind = {16: {1: "u2", 2: "i2"}, 32: {1: "u4", 2: "i4", 3: "f4"}}[bits][fmt]
    return s.astype(e + kind).view(np.uint8).reshape(rows, -1)


def _tiff_predict(rows: np.ndarray, predictor: int, width: int, spp: int,
                  bits: int, order: str) -> np.ndarray:
    if predictor == 1:
        return rows
    n = rows.shape[0]
    if predictor == 2:
        dt = np.dtype(f"{'<' if order == 'II' else '>'}u{bits // 8}")
        v = rows.copy().view(dt).reshape(n, width, spp).astype(np.int64)
        d = np.concatenate([v[:, :1], np.diff(v, axis=1)], 1) % (1 << bits)
        return d.astype(dt).view(np.uint8).reshape(n, -1)
    nb = bits // 8  # predictor 3: byte planes, most significant first
    be = rows.reshape(n, width * spp, nb)
    if order == "II":
        be = be[..., ::-1]
    planes = be.transpose(0, 2, 1).reshape(n, nb * width, spp).astype(np.int16)
    d = np.concatenate([planes[:, :1], np.diff(planes, axis=1)], 1) % 256
    return d.astype(np.uint8).reshape(n, -1)


def ycbcr_units(block: np.ndarray, hs: int, vs: int) -> bytes:
    """(rows, width, 3) Y, Cb, Cr samples packed as TIFF's subsampled
    YCbCr: for each ``hs`` x ``vs`` block (rows and columns past the edge
    repeat the last), its ``hs * vs`` Y samples row by row, then the
    block's mean Cb and Cr, rounded."""
    rows, width, _ = block.shape
    nh, nv = -(-width // hs), -(-rows // vs)
    ys = np.minimum(np.arange(nv * vs), rows - 1)
    xs = np.minimum(np.arange(nh * hs), width - 1)
    full = block[ys][:, xs].astype(np.float64)
    t = full.reshape(nv, vs, nh, hs, 3).transpose(0, 2, 1, 3, 4)
    luma = t[..., 0].reshape(nv, nh, vs * hs)
    chroma = np.floor(t[..., 1:].mean((2, 3)) + 0.5)
    return np.concatenate([luma, chroma], -1).astype(np.uint8).tobytes()


def _ycbcr_predict(raw: bytes, row: int) -> bytes:
    """Predictor 2 as libtiff applies it to packed YCbCr: rows of ``row``
    bytes (its scanline or tile row size), each differenced at a stride of
    3 bytes; where the rows do not divide so, libtiff's predictor refuses
    the chunk and leaves its bytes as they are, and so does this."""
    if row % 3 or len(raw) % row:
        return raw
    b = np.frombuffer(raw, np.uint8).reshape(-1, row // 3, 3).astype(np.int16)
    d = np.concatenate([b[:, :1], np.diff(b, axis=1)], 1) % 256
    return d.astype(np.uint8).tobytes()


def tiff_bytes(samples: np.ndarray, photometric: int, bits: int = 8,
               order: str = "II", bigtiff: bool = False, compression: int = 1,
               predictor: int = 1, planar: int = 1, tile=None,
               rows_per_strip: Optional[int] = None, extra=(),
               sample_format: Optional[int] = None, fill: int = 1,
               colormap: Optional[np.ndarray] = None, lzw_old: bool = False,
               jpeg_chunks: Optional[Sequence[bytes]] = None,
               jpeg_tables: Optional[bytes] = None, tags=None,
               zstd_codec=None, subsampling=None) -> bytes:
    """A TIFF of one image: ``samples`` (H, W[, spp]) in ``bits`` per
    sample (1, 2, 4, 8, 12, 16 or 32; ``sample_format`` 1 unsigned, 2
    signed, 3 float), strips of ``rows_per_strip`` or ``tile = (w, h)``
    tiles (edge tiles padded), planar 1 or 2; compression 1, 5 (LZW,
    ``lzw_old`` for the old style), 8/32946 (zlib), 32773 (PackBits),
    34925 (LZMA), 50000 (zstd: ``zstd_codec`` of a chunk's bytes, else
    the ``zstandard`` package's), 2, 3 or 4 (CCITT: ``fax_bytes`` of 1-bit
    samples, the options from ``tags``' 292 or 293) or 7 (``jpeg_chunks``:
    one JPEG per strip or tile, with ``jpeg_tables`` for the tag);
    predictor 2 or 3; fill order 2 reverses each stored byte's bits.
    ``subsampling = (hs, vs)``: YCbCr samples (photometric 6) packed in
    ``ycbcr_units`` a strip or tile, with tag 530 (predictor 2 on
    libtiff's rows of them).  ``colormap``: (2^bits, 3) uint16.  ``tags``:
    more (tag, type letter, values) entries, replacing any of the same
    tag.  Strips of the same bytes are compressed once."""
    s = samples if samples.ndim == 3 else samples[..., None]
    h, w, spp = s.shape
    fmt = sample_format or (3 if s.dtype.kind == "f" else 1)
    planes = [s[..., k:k + 1] for k in range(spp)] if planar == 2 else [s]
    per = 1 if planar == 2 else spp
    if tile:
        tw, th = tile
        boxes = [(x, y, tw, th) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        boxes = [(0, y, w, min(rps, h - y)) for y in range(0, h, rps)]
    chunks = []
    for p in planes:
        for x, y, cw, ch in boxes:
            block = np.zeros((ch, cw, per), s.dtype)
            part = p[y:y + ch, x:x + cw]
            block[:part.shape[0], :part.shape[1]] = part
            if subsampling:
                hs, vs = subsampling
                raw = ycbcr_units(block, hs, vs)
                if predictor == 2:  # TIFFTileRowSize; TIFFScanlineSize
                    row = cw * 3 if tile else len(ycbcr_units(
                        block[:vs], hs, vs)) // vs
                    raw = _ycbcr_predict(raw, row)
                chunks.append(raw)
                continue
            raw = _tiff_predict(_tiff_rows(block, bits, order, fmt), predictor,
                                cw, per, bits, order).tobytes()
            chunks.append(raw)
    if compression == 7:
        chunks = list(jpeg_chunks)
    elif compression in (2, 3, 4):  # bilevel rows, one fax stream a chunk
        opt = {t[0]: t[2][0] for t in tags or []}.get(
            293 if compression == 4 else 292, 0)
        chunks = []
        for p in planes:
            for x, y, cw, ch in boxes:
                block = np.zeros((ch, cw), np.uint8)
                part = p[y:y + ch, x:x + cw, 0]
                block[:part.shape[0], :part.shape[1]] = part
                chunks.append(fax_bytes(block, compression, opt))
    else:
        codec = {1: lambda b: b, 5: lambda b: lzw_tiff(b, lzw_old),
                 8: zlib.compress, 32946: zlib.compress, 32773: packbits,
                 34925: lambda b: __import__("lzma").compress(b),
                 50000: zstd_codec or (lambda b: __import__(
                     "zstandard").ZstdCompressor().compress(b))}[compression]
        done: Dict[bytes, bytes] = {}
        for c in chunks:
            if c not in done:
                done[c] = codec(c)
        chunks = [done[c] for c in chunks]
    if fill == 2:
        chunks = [_reverse_bits(c) for c in chunks]
    e = "<" if order == "II" else ">"
    head = 16 if bigtiff else 8
    data = bytearray(head)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
        if len(data) % 2:
            data += b"\0"
    entries = [(256, "I", [w]), (257, "I", [h]), (258, "H", [bits] * spp),
               (259, "H", [compression]), (262, "H", [photometric]),
               (277, "H", [spp]), (284, "H", [planar])]
    if fill != 1:
        entries.append((266, "H", [fill]))
    if predictor != 1:
        entries.append((317, "H", [predictor]))
    if extra:
        entries.append((338, "H", list(extra)))
    if subsampling:
        entries.append((530, "H", list(subsampling)))
    if sample_format:
        entries.append((339, "H", [sample_format] * spp))
    if colormap is not None:
        entries.append((320, "H", colormap.T.reshape(-1).tolist()))
    if jpeg_tables is not None:
        entries.append((347, "U", jpeg_tables))
    big_ofs = "Q" if bigtiff else "I"
    if tile:
        entries += [(322, "I", [tile[0]]), (323, "I", [tile[1]]),
                    (324, big_ofs, offsets), (325, big_ofs,
                                              [len(c) for c in chunks])]
    else:
        entries += [(273, big_ofs, offsets), (278, "I", [rows_per_strip or h]),
                    (279, big_ofs, [len(c) for c in chunks])]
    entries = sorted({t[0]: t for t in entries + list(tags or [])}.values(),
                     key=lambda t: t[0])  # ``tags`` replace written ones
    inline = 8 if bigtiff else 4
    ifd_at = len(data)
    n = len(entries)
    ifd_size = (8 + 20 * n + 8) if bigtiff else (2 + 12 * n + 4)
    extra_data = bytearray()
    body = bytearray(struct.pack(e + ("Q" if bigtiff else "H"), n))
    for tag, kind, vals in entries:
        if kind == "U":
            raw = bytes(vals)
            count = len(raw)
        elif kind == "R":  # RATIONAL: numerator, denominator pairs
            raw = struct.pack(e + "I" * len(vals), *vals)
            count = len(vals) // 2
        else:
            raw = struct.pack(e + kind * len(vals), *vals)
            count = len(vals)
        body += struct.pack(e + "HH", tag, _TIFF_TYPES[kind])
        body += struct.pack(e + ("Q" if bigtiff else "I"), count)
        if len(raw) <= inline:
            body += raw + b"\0" * (inline - len(raw))
        else:
            at = ifd_at + ifd_size + len(extra_data)
            body += struct.pack(e + ("Q" if bigtiff else "I"), at)
            extra_data += raw + (b"\0" if len(raw) % 2 else b"")
    body += b"\0" * inline
    data += body + extra_data
    if bigtiff:
        data[:16] = (order.encode() + struct.pack(e + "HHHQ", 43, 8, 0, ifd_at)[:14])
    else:
        data[:8] = order.encode() + struct.pack(e + "HI", 42, ifd_at)
    return bytes(data)


# ================================================================= WebP
def _riff(chunks) -> bytes:
    body = b"WEBP"
    for kind, payload in chunks:
        body += kind + struct.pack("<I", len(payload)) + payload
        if len(payload) % 2:
            body += b"\0"
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_container(frame: bytes, kind: bytes, alph: Optional[bytes] = None,
                   canvas=None, anim_offset=None, alpha_flag=None,
                   icc: bool = False) -> bytes:
    """A WebP file of one ``VP8 `` or ``VP8L`` bitstream: simple when no
    option is given, else extended (``VP8X``) with ``ALPH``, an ICC chunk,
    or an animation of this one frame at ``anim_offset`` (even x, y) on a
    ``canvas`` of (w, h)."""
    if alph is None and canvas is None and not icc and alpha_flag is None:
        return _riff([(kind, frame)])
    if kind == b"VP8 ":
        w, h = (v & 0x3FFF for v in struct.unpack("<HH", frame[6:10]))
    else:
        bits = int.from_bytes(frame[1:5], "little")
        w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    cw, ch = canvas or (w, h)
    has_alpha = alph is not None or kind == b"VP8L"
    flags = (0x10 if (has_alpha if alpha_flag is None else alpha_flag) else 0)
    flags |= (0x20 if icc else 0) | (0x02 if anim_offset is not None else 0)
    vp8x = bytes([flags, 0, 0, 0]) + (cw - 1).to_bytes(3, "little") + \
        (ch - 1).to_bytes(3, "little")
    chunks = [(b"VP8X", vp8x)]
    if icc:
        chunks.append((b"ICCP", b"\0" * 20))
    frame_chunks = ([(b"ALPH", alph)] if alph is not None else []) + [(kind, frame)]
    if anim_offset is None:
        chunks += frame_chunks
    else:
        x, y = anim_offset
        chunks.append((b"ANIM", struct.pack("<IH", 0xFF336699, 0)))
        anmf = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
                + (100).to_bytes(3, "little") + b"\0")
        for k, p in frame_chunks:
            anmf += k + struct.pack("<I", len(p)) + p + (b"\0" if len(p) % 2 else b"")
        chunks.append((b"ANMF", anmf))
    chunks.append((b"EXIF", b"Exif\0\0"))
    return _riff(chunks)


class _LsbWriter:
    """Bits lowest first, as VP8L reads them."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value: int, nbits: int):
        self.acc |= (value & ((1 << nbits) - 1)) << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def data(self) -> bytes:
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")

    def put_many(self, values: np.ndarray, nbits: np.ndarray):
        """``put`` of each (value, nbits) pair in turn (nbits <= 16), in
        numpy: each value's bits land in at most three bytes, and as no two
        overlap their byte sums are their ORs."""
        values = np.asarray(values, np.int64)
        nbits = np.asarray(nbits, np.int64)
        pos = self.n + np.cumsum(nbits) - nbits
        total = int(self.n + nbits.sum())
        nbytes = (total + 7) // 8
        v = values << (pos & 7)
        idx = pos >> 3
        acc = np.zeros(nbytes + 3, np.float64)
        for k in range(3):
            acc += np.bincount(idx + k, weights=(v >> (8 * k)) & 255,
                               minlength=nbytes + 3)
        block = acc[:nbytes].astype(np.uint8)
        if nbytes:
            block[0] |= self.acc
        full = total // 8
        self.out += block[:full].tobytes()
        self.n = total % 8
        self.acc = int(block[full]) if self.n else 0


def _huffman_lengths(freq: np.ndarray, limit: int) -> np.ndarray:
    """Prefix code lengths (at most ``limit``) for the counts ``freq``."""
    import heapq

    f = np.asarray(freq, np.int64).copy()
    while True:
        used = np.flatnonzero(f)
        lens = np.zeros(len(f), np.int64)
        if len(used) == 1:
            lens[used[0]] = 1
            return lens
        heap = [(int(f[i]), i, [i]) for i in used]
        heapq.heapify(heap)
        tie = len(f)
        while len(heap) > 1:
            a, _, la = heapq.heappop(heap)
            b, _, lb = heapq.heappop(heap)
            for i in la + lb:
                lens[i] += 1
            heapq.heappush(heap, (a + b, tie, la + lb))
            tie += 1
        if lens.max() <= limit:
            return lens
        f = np.where(f > 0, (f >> 1) | 1, 0)


def _canonical(lens: np.ndarray):
    """{symbol: (code, length)} of a canonical prefix code."""
    codes, code = {}, 0
    for length in range(1, 16):
        for sym in np.flatnonzero(lens == length):
            codes[int(sym)] = (code, length)
            code += 1
        code <<= 1
    return codes


def _put_code(bw: _LsbWriter, code, length):
    for k in range(length - 1, -1, -1):  # first bit first
        bw.put((code >> k) & 1, 1)


def _reversed_code(code: int, length: int) -> int:
    return int(f"{code:0{length}b}"[::-1], 2) if length else 0


def _put_literals(bw: _LsbWriter, flat: np.ndarray, codes) -> None:
    """Every pixel of ``flat`` (n, 4: a r g b) as green, red, blue and alpha
    literals of the four codes, in numpy."""
    vals, lens = [], []
    for code, ch in zip(codes, (2, 1, 3, 0)):
        size = max(code) + 1
        rev = np.zeros(size, np.int64)
        ln = np.zeros(size, np.int64)
        for sym, (c, n) in code.items():
            rev[sym], ln[sym] = _reversed_code(c, n), n
        vals.append(rev[flat[:, ch]])
        lens.append(ln[flat[:, ch]])
    bw.put_many(np.stack(vals, 1).reshape(-1), np.stack(lens, 1).reshape(-1))


_CL_ORDER = [17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def _vp8l_code(bw: _LsbWriter, freq: np.ndarray):
    """Write one prefix code for the counts ``freq``; its {symbol: code}."""
    used = np.flatnonzero(freq)
    if len(used) == 0:
        used = np.array([0])
    if len(used) <= 2 and used.max() < 256:
        bw.put(1, 1)
        bw.put(len(used) - 1, 1)
        first = int(used[0])
        if first < 2:
            bw.put(0, 1)
            bw.put(first, 1)
        else:
            bw.put(1, 1)
            bw.put(first, 8)
        if len(used) == 2:
            bw.put(int(used[1]), 8)
        if len(used) == 1:
            return {first: (0, 0)}
        return {first: (0, 1), int(used[1]): (1, 1)}
    lens = _huffman_lengths(freq, 15)
    cl_freq = np.bincount(lens, minlength=16)
    cl_lens = _huffman_lengths(np.concatenate([cl_freq, [0, 0, 0]]), 7)
    bw.put(0, 1)
    bw.put(19 - 4, 4)
    for sym in _CL_ORDER:
        bw.put(int(cl_lens[sym]), 3)
    bw.put(0, 1)  # every symbol's length is written
    cl_codes = _canonical(cl_lens)
    if len(cl_codes) == 1:  # a code of one symbol is read with no bits
        cl_codes = {k: (0, 0) for k in cl_codes}
    for length in lens:
        code = cl_codes.get(int(length))
        if code is not None:
            _put_code(bw, *code)
    codes = _canonical(lens)
    return {k: (0, 0) for k in codes} if len(codes) == 1 else codes


def _add_px(a, b):
    return ((a.astype(np.int64) + b) % 256).astype(np.uint8)


def _vp8l_predict(px: np.ndarray, mode: int, x: int, y: int) -> np.ndarray:
    """The predictor ``mode``'s value for (x, y) of an (H, W, 4) ARGB-order
    int image (channels a, r, g, b) whose earlier pixels are final."""
    w = px.shape[1]
    L = px[y, x - 1]
    T = px[y - 1, x]
    TL = px[y - 1, x - 1]
    TR = px[y - 1, x + 1] if x + 1 < w else px[y, 0]
    avg = lambda a, b: (a + b) // 2  # noqa: E731
    if mode == 0 or mode >= 14:
        return np.array([255, 0, 0, 0])
    if mode == 11:
        pa = np.abs(L - TL).sum() - np.abs(T - TL).sum()
        return T if pa <= 0 else L
    if mode == 12:
        return np.clip(L + T - TL, 0, 255)
    if mode == 13:
        a = avg(L, T)
        return np.clip(a + np.trunc((a - TL) / 2).astype(np.int64), 0, 255)
    return {1: L, 2: T, 3: TR, 4: TL, 5: avg(avg(L, TR), T), 6: avg(L, TL),
            7: avg(L, T), 8: avg(TL, T), 9: avg(T, TR),
            10: avg(avg(L, TL), avg(T, TR))}[mode]


def _vp8l_image(bw: _LsbWriter, argb: np.ndarray):
    """An entropy-coded image of (H, W, 4) a, r, g, b bytes: no colour
    cache, one group, literals only."""
    bw.put(0, 1)  # no colour cache
    flat = argb.reshape(-1, 4).astype(np.int64)
    codes = []
    for ch, size in ((2, 280), (1, 256), (3, 256), (0, 256)):
        codes.append(_vp8l_code(bw, np.bincount(flat[:, ch], minlength=size)))
    _vp8l_code(bw, np.zeros(40, np.int64))
    _put_literals(bw, flat, codes)


def _vp8l_stream(bw: _LsbWriter, rgba: np.ndarray, transforms, tile_bits: int,
                 seed: int):
    """The level-0 image stream of ``rgba`` (H, W, 4) after ``transforms``
    (a sequence of ``subtract_green``, ``predictor``, ``cross_color``,
    ``palette``), with a meta-code bit of 0."""
    rng = np.random.RandomState(seed)
    px = rgba[..., [3, 0, 1, 2]].astype(np.int64)  # a r g b
    h, w, _ = px.shape
    sub = lambda n: -(-n // (1 << tile_bits))  # noqa: E731
    for t in transforms:
        bw.put(1, 1)
        if t == "subtract_green":
            bw.put(2, 2)
            px = px.copy()
            px[..., 1] = (px[..., 1] - px[..., 2]) % 256
            px[..., 3] = (px[..., 3] - px[..., 2]) % 256
        elif t == "cross_color":
            bw.put(1, 2)
            bw.put(tile_bits - 2, 3)
            mult = rng.randint(0, 256, (sub(h), sub(w), 3))
            sub_img = np.zeros((sub(h), sub(w), 4), np.int64)
            sub_img[..., 0] = 255
            sub_img[..., 3], sub_img[..., 2], sub_img[..., 1] = (
                mult[..., 0], mult[..., 1], mult[..., 2])
            _vp8l_image(bw, sub_img)
            s8 = lambda v: ((v + 128) % 256) - 128  # noqa: E731
            m = mult[np.arange(h)[:, None] >> tile_bits,
                     np.arange(w)[None, :] >> tile_bits]
            g, r, b = s8(px[..., 2]), px[..., 1], px[..., 3]
            nr = (r - ((s8(m[..., 0]) * g) >> 5)) % 256
            nb = (b - ((s8(m[..., 1]) * g) >> 5) - ((s8(m[..., 2]) * s8(r)) >> 5)) % 256
            px = px.copy()
            px[..., 1], px[..., 3] = nr, nb
        elif t == "predictor":
            bw.put(0, 2)
            bw.put(tile_bits - 2, 3)
            modes = rng.randint(0, 16, (sub(h), sub(w)))
            sub_img = np.zeros((sub(h), sub(w), 4), np.int64)
            sub_img[..., 0] = 255
            sub_img[..., 2] = modes
            _vp8l_image(bw, sub_img)
            res = np.zeros_like(px)
            for y in range(h):
                for x in range(w):
                    if y == 0 and x == 0:
                        pred = np.array([255, 0, 0, 0])
                    elif y == 0:
                        pred = px[0, x - 1]
                    elif x == 0:
                        pred = px[y - 1, 0]
                    else:
                        pred = _vp8l_predict(px, modes[y >> tile_bits,
                                                       x >> tile_bits], x, y)
                    res[y, x] = (px[y, x] - pred) % 256
            px = res
        elif t == "palette":
            bw.put(3, 2)
            colours, idx = np.unique(px.reshape(-1, 4), axis=0,
                                     return_inverse=True)
            n = len(colours)
            bw.put(n - 1, 8)
            delta = np.concatenate([colours[:1], np.diff(colours, axis=0) % 256])
            _vp8l_image(bw, delta.reshape(1, n, 4))
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            per, bpp = 1 << bits, 8 >> bits
            idx = idx.reshape(h, w)
            pw = -(-w // per)
            packed = np.zeros((h, pw), np.int64)
            for k in range(per):
                cols = idx[:, k::per]
                packed[:, :cols.shape[1]] |= cols << (k * bpp)
            px = np.zeros((h, pw, 4), np.int64)
            px[..., 0] = 255
            px[..., 2] = packed
            w = pw
    bw.put(0, 1)  # no more transforms
    bw.put(0, 1)  # no colour cache
    bw.put(0, 1)  # no meta prefix codes
    flat = px.reshape(-1, 4)
    codes = []
    for ch, size in ((2, 280), (1, 256), (3, 256), (0, 256)):
        codes.append(_vp8l_code(bw, np.bincount(flat[:, ch], minlength=size)))
    _vp8l_code(bw, np.zeros(40, np.int64))
    _put_literals(bw, flat, codes)


def vp8l_bytes(rgba: np.ndarray, transforms=(), tile_bits: int = 2,
               alpha_hint: bool = True, seed: int = 0) -> bytes:
    """A VP8L bitstream (``VP8L`` chunk payload) of an (H, W, 4) uint8
    image: literals only, one prefix-code group, after ``transforms``."""
    h, w, _ = rgba.shape
    bw = _LsbWriter()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(int(alpha_hint), 1)
    bw.put(0, 3)
    _vp8l_stream(bw, rgba, transforms, tile_bits, seed)
    return bw.data()


def alph_bytes(alpha: np.ndarray, method: int = 0, filt: int = 0) -> bytes:
    """An ``ALPH`` chunk payload: ``method`` 0 raw or 1 VP8L-coded (the
    values in green), ``filt`` 0 none, 1 horizontal, 2 vertical, 3
    gradient."""
    a = alpha.astype(np.int64)
    h, w = a.shape
    pred = np.zeros_like(a)
    if filt:
        pred[0, 1:] = a[0, :-1]
        pred[1:, 0] = a[:-1, 0]
        if filt == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif filt == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    res = ((a - pred) % 256).astype(np.uint8)
    head = bytes([method | (filt << 2)])
    if method == 0:
        return head + res.tobytes()
    bw = _LsbWriter()
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 1] = res
    _vp8l_stream(bw, img, (), 2, 0)
    return head + bw.data()


def _webp_tables():
    """kCoeffsProba0 and kBModesProba from the port's decoder source."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                            "nerf_pl_tpu_torch", "csrc", "webp_decode.cpp")).read()

    def table(name):
        body = re.search(name + r"\[\d+\] = \{(.*?)\};", src, re.S).group(1)
        return [int(v) for v in re.findall(r"\d+", body)]

    return (np.array(table("kCoeffsProba0")).reshape(4, 8, 3, 11),
            np.array(table("kBModesProba")).reshape(10, 10, 9))


class _BoolWriter:
    """RFC 6386's boolean entropy encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int = 128):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def lit(self, v: int, n: int):
        for k in range(n - 1, -1, -1):
            self.put((v >> k) & 1)

    def signed(self, v: int, n: int):
        self.lit(abs(v), n)
        self.put(int(v < 0))

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append((v >> 24) & 0xFF)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out) + b"\0" * 8


_ZIGZAG_BANDS = [0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0]


def _vp8_tokens(bw: _BoolWriter, proba, typ: int, ctx: int, first: int,
                vals: Dict[int, int]) -> int:
    """One block's coefficient tokens (``vals``: scan position -> nonzero
    value, at most 18 in magnitude); returns the decoder's ``nz``."""
    n = first
    p = proba[typ][_ZIGZAG_BANDS[n]][ctx]
    last = max(vals) if vals else -1
    while n < 16:
        if n > last:
            bw.put(0, p[0])
            return n
        bw.put(1, p[0])
        while vals.get(n, 0) == 0:
            bw.put(0, p[1])
            n += 1
            p = proba[typ][_ZIGZAG_BANDS[n]][0]
        bw.put(1, p[1])
        v = abs(vals[n])
        if v == 1:
            bw.put(0, p[2])
            nctx = 1
        else:
            bw.put(1, p[2])
            nctx = 2
            if v <= 4:
                bw.put(0, p[3])
                if v == 2:
                    bw.put(0, p[4])
                else:
                    bw.put(1, p[4])
                    bw.put(v - 3, p[5])
            elif v <= 10:
                bw.put(1, p[3])
                bw.put(0, p[6])
                if v <= 6:
                    bw.put(0, p[7])
                    bw.put(v - 5, 159)
                else:
                    bw.put(1, p[7])
                    bw.put((v - 7) >> 1, 165)
                    bw.put((v - 7) & 1, 145)
            else:  # category 3: 11-18
                bw.put(1, p[3])
                bw.put(1, p[6])
                bw.put(0, p[8])
                bw.put(0, p[9])
                for k, prob in zip((2, 1, 0), (173, 148, 140)):
                    bw.put(((v - 11) >> k) & 1, prob)
        bw.put(int(vals[n] < 0))
        n += 1
        p = proba[typ][_ZIGZAG_BANDS[n]][nctx]
    return 16


def vp8_bytes(w: int, h: int, seed: int = 0, simple: bool = False,
              level: int = 20, sharpness: int = 0, partitions: int = 0,
              segments: bool = False, absolute: bool = False,
              lf_delta: bool = False, skip_proba: Optional[int] = None,
              base_q: int = 40, i4_share: float = 0.5,
              proba_updates: int = 0) -> bytes:
    """A VP8 key frame (``VP8 `` chunk payload) of random intra modes and
    small random coefficients (DC and the first AC of each block): what
    Pillow's encoder never writes (the simple filter, 2/4/8 token
    partitions, absolute segment values, loop-filter deltas, sharpness)."""
    rng = np.random.RandomState(seed)
    coeffs0, bmodes = _webp_tables()
    proba = coeffs0.copy()
    mbw, mbh = -(-w // 16), -(-h // 16)
    first = _BoolWriter()
    first.put(0)  # colour space
    first.put(0)  # clamping
    first.put(int(segments))
    seg_proba = [100, 150, 200]
    if segments:
        first.put(1)  # update map
        first.put(1)  # update data
        first.put(int(absolute))
        for s in range(4):
            q = rng.randint(5, 100) if absolute else rng.randint(-20, 21)
            first.put(1)
            first.signed(q, 7)
        for s in range(4):
            first.put(1)
            first.signed(rng.randint(0, 40) if absolute else rng.randint(-10, 11), 6)
        for p in seg_proba:
            first.put(1)
            first.lit(p, 8)
    first.put(int(simple))
    first.lit(level, 6)
    first.lit(sharpness, 3)
    first.put(int(lf_delta))
    if lf_delta:
        first.put(1)
        for d in (rng.randint(-15, 16), 0, 0, 0):
            first.put(1)
            first.signed(d, 6)
        for d in (rng.randint(-15, 16), 0, 0, 0):
            first.put(1)
            first.signed(d, 6)
    first.lit(partitions, 2)
    first.lit(base_q, 7)
    for _ in range(5):
        d = rng.randint(-8, 9)
        first.put(1)
        first.signed(d, 4)
    first.put(0)  # refresh entropy probs
    from_update = np.zeros(proba.size, bool)
    from_update[rng.choice(proba.size, proba_updates, replace=False)] = True
    upd = _webp_update_proba()
    for i in range(proba.size):
        if from_update[i]:
            first.put(1, int(upd[i]))
            v = int(rng.randint(1, 256))
            first.lit(v, 8)
            proba.reshape(-1)[i] = v
        else:
            first.put(0, int(upd[i]))
    first.put(int(skip_proba is not None))
    if skip_proba is not None:
        first.lit(skip_proba, 8)
    nparts = 1 << partitions
    parts = [_BoolWriter() for _ in range(nparts)]
    intra_t = np.zeros(4 * mbw, np.int64)
    nz_top = [0] * mbw
    nz_dc_top = [0] * mbw
    for my in range(mbh):
        intra_l = [0, 0, 0, 0]
        nz_left = nz_dc_left = 0
        tb = parts[my & (nparts - 1)]
        for mx in range(mbw):
            if segments:
                seg = rng.randint(0, 4)
                if seg < 2:
                    first.put(0, seg_proba[0])
                    first.put(seg, seg_proba[1])
                else:
                    first.put(1, seg_proba[0])
                    first.put(seg - 2, seg_proba[2])
            skip = 0
            if skip_proba is not None:
                skip = int(rng.rand() < 0.3)
                first.put(skip, skip_proba)
            is_i4 = int(rng.rand() < i4_share)
            first.put(1 - is_i4, 145)
            top = intra_t[4 * mx:4 * mx + 4]
            if not is_i4:
                ym = rng.randint(0, 4)  # DC TM VE HE
                bits = {0: (0, 0), 2: (0, 1), 3: (1, 0), 1: (1, 1)}[ym]
                first.put(bits[0], 156)
                first.put(bits[1], 163 if bits[0] == 0 else 128)
                top[:] = ym
                intra_l = [ym] * 4
            else:
                for y in range(4):
                    left = intra_l[y]
                    for x in range(4):
                        m = rng.randint(0, 10)
                        pr = bmodes[top[x], left]
                        path = {0: [(0, 0)], 1: [(1, 0), (0, 1)],
                                2: [(1, 0), (1, 1), (0, 2)],
                                3: [(1, 0), (1, 1), (1, 2), (0, 3), (0, 4)],
                                4: [(1, 0), (1, 1), (1, 2), (0, 3), (1, 4), (0, 5)],
                                5: [(1, 0), (1, 1), (1, 2), (0, 3), (1, 4), (1, 5)],
                                6: [(1, 0), (1, 1), (1, 2), (1, 3), (0, 6)],
                                7: [(1, 0), (1, 1), (1, 2), (1, 3), (1, 6), (0, 7)],
                                8: [(1, 0), (1, 1), (1, 2), (1, 3), (1, 6), (1, 7),
                                    (0, 8)],
                                9: [(1, 0), (1, 1), (1, 2), (1, 3), (1, 6), (1, 7),
                                    (1, 8)]}[m]
                        for bit, k in path:
                            first.put(bit, int(pr[k]))
                        top[x] = m
                        left = m
                    intra_l[y] = left
            uvm = rng.randint(0, 4)
            uv_path = {0: [(0, 142)], 2: [(1, 142), (0, 114)],
                       3: [(1, 142), (1, 114), (0, 183)],
                       1: [(1, 142), (1, 114), (1, 183)]}[uvm]
            for bit, prob in uv_path:
                first.put(bit, prob)
            if skip:
                nz_top[mx] = nz_left = 0
                if not is_i4:
                    nz_dc_top[mx] = nz_dc_left = 0
                continue

            def rand_block(pos0):
                vals = {}
                if rng.rand() < 0.7:
                    vals[pos0] = int(rng.choice([-1, 1]) * rng.randint(1, 19))
                if rng.rand() < 0.4:
                    vals[pos0 + 1 + rng.randint(0, 3)] = int(
                        rng.choice([-1, 1]) * rng.randint(1, 5))
                return vals

            if not is_i4:
                ctx = nz_dc_top[mx] + nz_dc_left
                nz = _vp8_tokens(tb, proba, 1, ctx, 0, rand_block(0))
                nz_dc_top[mx] = nz_dc_left = int(nz > 0)
                first_pos, ac_type = 1, 0
            else:
                first_pos, ac_type = 0, 3
            tnz, lnz = nz_top[mx] & 0x0F, nz_left & 0x0F
            for y in range(4):
                l = lnz & 1
                for x in range(4):
                    ctx = l + (tnz & 1)
                    vals = rand_block(first_pos) if rng.rand() < 0.6 else {}
                    nz = _vp8_tokens(tb, proba, ac_type, ctx, first_pos, vals)
                    l = int(nz > first_pos)
                    tnz = (tnz >> 1) | (l << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (l << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz = nz_top[mx] >> (4 + ch)
                lnz = nz_left >> (4 + ch)
                for y in range(2):
                    l = lnz & 1
                    for x in range(2):
                        ctx = l + (tnz & 1)
                        vals = rand_block(0) if rng.rand() < 0.6 else {}
                        nz = _vp8_tokens(tb, proba, 2, ctx, 0, vals)
                        l = int(nz > 0)
                        tnz = (tnz >> 1) | (l << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (l << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            nz_top[mx] = out_t & 0xFF
            nz_left = out_l & 0xFF
    part0 = first.flush()
    tokens = [p.flush() for p in parts]
    tag = (len(part0) << 5) | (1 << 4)
    head = struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a" + struct.pack(
        "<HH", w, h)
    sizes = b"".join(struct.pack("<I", len(t))[:3] for t in tokens[:-1])
    return head + part0 + sizes + b"".join(tokens)


def _webp_update_proba():
    """The VP8 coefficient update probabilities from the decoder source."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                            "nerf_pl_tpu_torch", "csrc", "webp_decode.cpp")).read()
    body = re.search(r"kCoeffsUpdateProba\[\d+\] = \{(.*?)\};", src, re.S).group(1)
    return np.array([int(v) for v in re.findall(r"\d+", body)])


# ============================================================ PPM, BMP, GIF
def ppm_bytes(img: np.ndarray, magic: bytes, maxval: int = 255,
              comment: bool = False) -> bytes:
    """A Netpbm file: ``P1``-``P6`` (``img`` (H, W) or (H, W, 3) of values
    up to ``maxval``; for P1/P4 nonzero is black) or ``Pf`` (float32 (H, W),
    little-endian)."""
    h, w = img.shape[:2]
    head = magic + (b"\n# written by the tests\n" if comment else b"\n")
    head += b"%d %d\n" % (w, h)
    if magic == b"Pf":
        return head + b"-1.0\n" + img[::-1].astype("<f4").tobytes()
    if magic in (b"P1", b"P4"):
        bits = (img != 0).astype(np.uint8)
        if magic == b"P1":
            return head + b"\n".join(b" ".join(b"%d" % v for v in row)
                                     for row in bits) + b"\n"
        return head + np.packbits(bits, axis=1).tobytes()
    head += b"%d\n" % maxval
    if magic in (b"P2", b"P3"):
        return head + b"\n".join(b" ".join(b"%d" % v for v in row.reshape(-1))
                                 for row in img) + b"\n"
    dt = ">u2" if maxval > 255 else np.uint8
    return head + img.astype(dt).tobytes()


def _rle_row(row: np.ndarray, rle4: bool) -> bytes:
    """One row of BMP RLE8/RLE4: repeats as (count, value), runs of more
    than two differing values as absolute runs (word-aligned)."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 254:
            j += 1
        if j > i or n - i < 3:
            k = j - i + 1
            v = int(row[i])
            out += bytes([k, (v << 4) | v if rle4 else v])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 254 and not (j + 1 < n and row[j + 1] == row[j]):
            j += 1
        k = j - i
        if k < 3:
            for v in row[i:j]:
                out += bytes([1, (int(v) << 4) if rle4 else int(v)])
            i = j
            continue
        vals = row[i:j].astype(np.uint8)
        if rle4:
            if k % 2:
                vals = np.append(vals, 0)
            data = ((vals[0::2] << 4) | vals[1::2]).astype(np.uint8).tobytes()
        else:
            data = vals.tobytes()
        out += bytes([0, k]) + data + (b"\0" if len(data) % 2 else b"")
        i = j
    return bytes(out)


def bmp_bytes(img: np.ndarray, bits: int, palette: Optional[np.ndarray] = None,
              header: int = 40, top_down: bool = False, rle: bool = False,
              masks: Optional[Sequence[int]] = None) -> bytes:
    """A BMP: ``img`` (H, W) indices for 1/4/8 bits with ``palette`` (n, 3)
    RGB, or (H, W, 3|4) RGB(A) for 16 (5-5-5 or the ``masks``), 24 and 32
    bits (``masks`` for BI_BITFIELDS, 4 of them with alpha); ``header`` 12,
    40, 108 or 124 bytes; RLE8/RLE4 for 8- and 4-bit indices."""
    h, w = img.shape[:2]
    comp = (1 if bits == 8 else 2) if rle else (3 if masks else 0)
    rows = []
    for y in range(h):
        row = img[y]
        if rle:
            rows.append(_rle_row(row, bits == 4) + b"\0\0")
            continue
        if bits in (1, 4, 8):
            v = row.astype(np.uint8)
            if bits < 8:
                bitsarr = (v[:, None] >> np.arange(bits - 1, -1, -1)) & 1
                data = np.packbits(bitsarr.reshape(-1).astype(np.uint8)).tobytes()
            else:
                data = v.tobytes()
        elif bits == 16:
            m = masks or (0x7C00, 0x3E0, 0x1F)
            px = np.zeros(w, np.uint32)
            for c in range(3):
                shift = int(m[c]).bit_length() - bin(m[c]).count("1")
                top = m[c] >> shift
                px |= ((row[:, c].astype(np.uint32) * top // 255) << shift).astype(np.uint32)
            data = px.astype("<u2").tobytes()
        elif masks:
            px = np.zeros(w, np.uint64)
            for c, m in enumerate(masks):
                if m and c < row.shape[1]:
                    shift = int(m).bit_length() - 8
                    px |= row[:, c].astype(np.uint64) << np.uint64(shift)
            data = px.astype(f"<u{bits // 8}").tobytes() if bits == 32 else \
                b"".join(int(v).to_bytes(3, "little") for v in px)
        else:
            bgr = row[:, [2, 1, 0]].astype(np.uint8)
            if bits == 32:
                bgr = np.concatenate([bgr, np.zeros((w, 1), np.uint8)], 1)
            data = bgr.tobytes()
        pad = -len(data) % 4
        rows.append(data + b"\0" * pad)
    if not top_down:
        rows = rows[::-1]
    if rle:
        rows[-1] = rows[-1][:-2] + b"\0\1"
    pixels = b"".join(rows)
    pal = b""
    if palette is not None:
        for r, g, b in palette:
            pal += bytes([b, g, r]) + (b"" if header == 12 else b"\0")
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1,
                           bits, comp, len(pixels), 2835, 2835,
                           len(palette) if palette is not None else 0, 0)
        if header >= 52:
            m = list(masks or (0, 0, 0, 0)) + [0] * 4
            info += struct.pack("<IIII", *m[:4])
        info += b"\0" * (header - len(info))
    extra = b""
    if header == 40 and masks:
        extra = struct.pack("<III", *masks[:3])
    offset = 14 + len(info) + len(extra) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
    return head + info + extra + pal + pixels


def lzw_gif(indices: np.ndarray, bits: int) -> bytes:
    """GIF LZW codes (lowest bit first) of ``indices`` at minimum code size
    ``bits``: Clear first, Clear when the table fills, End last."""
    clear, end = 1 << bits, (1 << bits) + 1
    acc, nacc, out = 0, 0, bytearray()

    def put(code, width):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    width, nxt, table, w = bits + 1, clear + 2, {}, b""
    put(clear, width)
    for c in indices.reshape(-1).astype(np.uint8).tobytes():
        wc = w + bytes([c])
        if not w or wc in table:
            w = wc
            continue
        put(table[w] if len(w) > 1 else w[0], width)
        table[wc] = nxt
        nxt += 1
        if nxt > (1 << width) and width < 12:
            width += 1
        if nxt >= 4096:
            put(clear, width)
            width, nxt, table = bits + 1, clear + 2, {}
        w = bytes([c])
    if w:
        put(table[w] if len(w) > 1 else w[0], width)
        nxt += 1
        if nxt > (1 << width) and width < 12:
            width += 1
    put(end, width)
    if nacc:
        put(0, 8 - nacc)
    return bytes(out)


def gif_bytes(indices: np.ndarray, palette: Optional[np.ndarray],
              local: bool = False, interlace: bool = False,
              transparency: Optional[int] = None, screen=None, offset=(0, 0),
              background: int = 0, version: bytes = b"GIF89a") -> bytes:
    """A GIF of one frame of (h, w) ``indices``: ``palette`` (n, 3) as the
    global or ``local`` table (None: no table), interlaced or not, a
    Graphic Control transparency index, on a ``screen`` (w, h) at
    ``offset``."""
    h, w = indices.shape
    sw, sh = screen or (w, h)
    bits = 1
    if palette is not None:
        while (1 << bits) < len(palette):
            bits += 1
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(palette)] = palette
        table = table.tobytes()
    flags_g = (0x80 | (bits - 1)) if palette is not None and not local else 0
    out = version + struct.pack("<HHBBB", sw, sh, flags_g, background, 0)
    if flags_g:
        out += table
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1]) + b"\0\0" + bytes([transparency]) + b"\0"
    out += b"!\xfe\x05hello\x00"  # a comment extension
    flags_l = (0x80 | (bits - 1)) if palette is not None and local else 0
    flags_l |= 0x40 if interlace else 0
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, flags_l)
    if flags_l & 0x80:
        out += table
    rows = indices
    if interlace:
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                np.arange(2, h, 4), np.arange(1, h, 2)])
        rows = indices[order]
    code_size = max(2, int(indices.max()).bit_length())
    data = lzw_gif(rows, code_size)
    out += bytes([code_size])
    for i in range(0, len(data), 255):
        block = data[i:i + 255]
        out += bytes([len(block)]) + block
    return out + b"\0;"


# ------------------------------------------------------------------ DDS
DDS_RGB, DDS_ALPHAPIXELS, DDS_FOURCC = 0x40, 0x1, 0x4
DDS_PAL8, DDS_LUMINANCE = 0x20, 0x20000


def dds_bytes(w: int, h: int, body: bytes, pfflags: int,
              fourcc: bytes = b"\0\0\0\0", bitcount: int = 0,
              masks: Sequence[int] = (0, 0, 0, 0), dxgi: Optional[int] = None,
              palette: Optional[bytes] = None) -> bytes:
    """A DDS file: the 124-byte header (one mip level), a DX10 header where
    ``dxgi`` is given (FourCC ``DX10``), a 1,024-byte RGBA ``palette``, then
    ``body``."""
    if dxgi is not None:
        fourcc, pfflags = b"DX10", pfflags | DDS_FOURCC
    head = struct.pack("<4sI6I44x", b"DDS ", 124, 0x1007, h, w, 0, 0, 1)
    head += struct.pack("<2I4s5I", 32, pfflags, fourcc, bitcount,
                        *(list(masks) + [0] * 4)[:4])
    head += struct.pack("<4I4x", 0x1000, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + (palette or b"") + body


def dds_masks(img: np.ndarray, masks: Sequence[int], bitcount: int) -> bytes:
    """Pixels (h, w, c) of 8 bits each packed into ``bitcount``-bit
    little-endian words under ``masks`` (each value scaled to its mask's
    width by truncation)."""
    h, w, c = img.shape
    word = np.zeros((h, w), np.uint64)
    for k, m in enumerate(masks[:c]):
        if not m:
            continue
        shift = (m & -m).bit_length() - 1
        top = m >> shift
        v = img[..., k].astype(np.uint64) * np.uint64(top) // np.uint64(255)
        word |= (v << np.uint64(shift)) & np.uint64(m)
    nbytes = bitcount // 8
    out = np.zeros((h, w, nbytes), np.uint8)
    for k in range(nbytes):
        out[..., k] = (word >> np.uint64(8 * k)) & np.uint64(0xFF)
    return out.tobytes()


def bc7_mode6_bytes(rgba: np.ndarray) -> bytes:
    """A crude BC7 encoder: every 4x4 block in mode 6 (7-bit RGBA endpoints
    with a p-bit each, 4-bit indices), its endpoints the block's channel
    minimum and maximum, each pixel's index its projection onto the line
    between them.  Edges are padded by repeating the last row and
    column."""
    h, w, _ = rgba.shape
    bh, bw = -(-h // 4), -(-w // 4)
    img = np.pad(rgba.astype(np.int64), ((0, 4 * bh - h), (0, 4 * bw - w),
                                         (0, 0)), mode="edge")
    blocks = img.reshape(bh, 4, bw, 4, 4).transpose(0, 2, 1, 3, 4).reshape(
        -1, 16, 4)
    lo, hi = blocks.min(1), blocks.max(1)
    e = [np.clip(v >> 1, 0, 127) for v in (lo, hi)]  # 7 bits, p-bit 0 / 1
    e[1] = np.maximum(e[1], e[0])
    q = [(ee << 1) | p for ee, p in ((e[0], 0), (e[1], 1))]
    d = (q[1] - q[0]).astype(np.float64)
    t = ((blocks - q[0][:, None]) * d[:, None]).sum(-1) / np.maximum(
        (d * d).sum(-1), 1)[:, None]
    idx = np.clip(np.rint(t * 15), 0, 15).astype(np.int64)
    # the anchor (pixel 0) must have its top bit clear: swap the endpoints
    swap = idx[:, 0] >= 8
    idx = np.where(swap[:, None], 15 - idx, idx)
    e0 = np.where(swap[:, None], e[1], e[0])
    e1 = np.where(swap[:, None], e[0], e[1])
    p0 = np.where(swap, 1, 0)
    p1 = 1 - p0
    out = bytearray()
    for k in range(len(blocks)):
        v, pos = 1 << 6, 7  # mode 6
        for c in range(4):
            v |= int(e0[k, c]) << pos
            v |= int(e1[k, c]) << (pos + 7)
            pos += 14
        v |= int(p0[k]) << pos
        v |= int(p1[k]) << (pos + 1)
        pos += 2
        for i in range(16):
            n = 3 if i == 0 else 4
            v |= int(idx[k, i]) << pos
            pos += n
        out += v.to_bytes(16, "little")
    return bytes(out)


# ------------------------------------------------------------------ TGA
def tga_bytes(raw: np.ndarray, itype: int, depth: int, cmap: bytes = b"",
              cmap_depth: int = 0, cmap_first: int = 0, top_down: bool = False,
              rtl: bool = False, image_id: bytes = b"", extra: int = 0,
              width: Optional[int] = None) -> bytes:
    """A TGA of ``raw`` (h, w, bytes a pixel) stored pixel bytes (BGR(A),
    gray + alpha, 16-bit words as two bytes, indices), or (h, ceil(w / 8))
    packed bits at depth 1; types 9-11 as run-length packets (runs inside a
    row, raw packets running on over rows).  ``cmap`` is the colour map's
    stored entries; ``extra`` sets the descriptor's other bits; ``width``
    is the image's where it is not ``raw``'s (1 bit a pixel)."""
    h, w = raw.shape[0], width or raw.shape[1]
    flags = (0x20 if top_down else 0) | (0x10 if rtl else 0) | extra
    rows = raw if top_down else raw[::-1]
    if rtl:
        rows = rows[:, ::-1]
    ncmap = len(cmap) // max(1, cmap_depth // 8) if cmap_depth else 0
    head = struct.pack("<BBBHHBHHHHBB", len(image_id), 1 if cmap_depth else 0,
                       itype, cmap_first, ncmap, cmap_depth, 0, 0, w, h, depth,
                       flags)
    if itype < 8:
        return head + image_id + cmap + rows.tobytes()
    bpp = depth // 8
    px = rows.reshape(h * w, bpp)
    out, i, n = bytearray(), 0, h * w
    while i < n:
        j = i  # a run: equal pixels in the same row
        while (j + 1 < n and (j + 1) % w and j - i < 127
               and (px[j + 1] == px[i]).all()):
            j += 1
        if j > i:
            out += bytes([0x80 | (j - i)]) + px[i].tobytes()
            i = j + 1
            continue
        j = i + 1  # a raw packet, over rows where it must
        while j < n and j - i < 128 and not (
                j + 1 < n and (j + 1) % w and (px[j + 1] == px[j]).all()):
            j += 1
        out += bytes([j - i - 1]) + px[i:j].tobytes()
        i = j
    return head + image_id + cmap + bytes(out)


# ------------------------------------------------------------------ SGI
def _sgi_rle_row(v: np.ndarray, bpc: int) -> bytes:
    """One channel's row as SGI packets: repeats, literals, a 0 count."""
    fmt = ">u2" if bpc == 2 else "u1"

    def count(c):
        return c.to_bytes(bpc, "big")
    out, i, n = bytearray(), 0, len(v)
    while i < n:
        j = i
        while j + 1 < n and v[j + 1] == v[i] and j - i < 126:
            j += 1
        if j > i:
            out += count(j - i + 1) + np.array([v[i]], fmt).tobytes()
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 127 and not (j + 1 < n and v[j + 1] == v[j]):
            j += 1
        out += count(0x80 | (j - i)) + v[i:j].astype(fmt).tobytes()
        i = j
    return bytes(out) + count(0)


def sgi_bytes(img: np.ndarray, bpc: int = 1, rle: bool = False,
              dimension: Optional[int] = None) -> bytes:
    """An SGI file of ``img`` (h, w) or (h, w, z) samples (below 2^(8 bpc)),
    rows bottom-up, raw planes or run-length rows behind their tables."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, z = img.shape
    dim = dimension or (3 if z > 1 else 2)
    head = struct.pack(">HBBHHHHii4x80si", 474, int(rle), bpc, dim, w, h, z,
                       0, (1 << (8 * bpc)) - 1, b"port", 0).ljust(512, b"\0")
    fmt = ">u2" if bpc == 2 else "u1"
    planes = [img[::-1, :, c] for c in range(z)]
    if not rle:
        return head + b"".join(p.astype(fmt).tobytes() for p in planes)
    body, starts, lengths = bytearray(), [], []
    base = 512 + 8 * h * z
    for p in planes:
        for y in range(h):
            row = _sgi_rle_row(p[y], bpc)
            starts.append(base + len(body))
            lengths.append(len(row))
            body += row
    tabs = np.array(starts, ">u4").tobytes() + np.array(lengths, ">u4").tobytes()
    return head + tabs + bytes(body)


# ------------------------------------------------------------------ PCX
def _pcx_rle_row(row: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 62:
            j += 1
        k, v = j - i + 1, row[i]
        out += bytes([v]) if k == 1 and v < 0xC0 else bytes([0xC0 | k, v])
        i = j + 1
    return bytes(out)


def pcx_bytes(planes: np.ndarray, bits: int, version: int = 5,
              palette16: Optional[np.ndarray] = None,
              palette256: Optional[np.ndarray] = None,
              even_stride: bool = True, origin=(0, 0)) -> bytes:
    """A PCX of ``planes`` (p, h, w) samples of ``bits`` bits (each plane
    packed MSB first), each row's planes run-length coded together; the
    header's stride made even when ``even_stride``; a 16-entry header
    palette and a trailing 256-entry one where given."""
    p, h, w = planes.shape
    stride = (w * bits + 7) // 8
    if even_stride:
        stride += stride % 2
    rows = []
    for y in range(h):
        row = b""
        for k in range(p):
            v = planes[k, y].astype(np.uint8)
            if bits < 8:
                b = (v[:, None] >> np.arange(bits - 1, -1, -1)) & 1
                data = np.packbits(b.reshape(-1).astype(np.uint8)).tobytes()
            else:
                data = v.tobytes()
            row += data.ljust(stride, b"\0")
        rows.append(_pcx_rle_row(row))
    pal16 = (np.zeros((16, 3), np.uint8) if palette16 is None
             else np.asarray(palette16, np.uint8)).tobytes()
    x0, y0 = origin
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, x0, y0,
                       x0 + w - 1, y0 + h - 1, 72, 72) + pal16
    head += struct.pack("<BBHH", 0, p, stride, 1).ljust(128 - len(head), b"\0")
    tail = b""
    if palette256 is not None:
        tail = b"\x0c" + np.asarray(palette256, np.uint8).tobytes()
    return head + b"".join(rows) + tail


# ------------------------------------------------------------------ QOI
def qoi_bytes(img: np.ndarray, channels: Optional[int] = None,
              explicit_first: bool = False) -> bytes:
    """A QOI of ``img`` (h, w, 3|4), every op where it fits, vectorised:
    runs (62 at most) of a pixel equal to the one before, an index op where
    the last pixel of the same hash holds the same value, else a diff, luma,
    RGB or RGBA op.  ``explicit_first`` writes the first pixel as an RGBA op,
    so that the op stream decodes the same after any other (it can be
    repeated to tile the image down the rows)."""
    h, w, c = img.shape
    px = img.reshape(-1, c).astype(np.int64)
    if c == 3:
        px = np.concatenate([px, np.full((len(px), 1), 255)], 1)
    n = len(px)
    prev = np.concatenate([[[0, 0, 0, 255]], px[:-1]])
    same = (px == prev).all(1)
    same[0] = False  # the first pixel enters the index, as an op must put it
    hsh = (px[:, 0] * 3 + px[:, 1] * 5 + px[:, 2] * 7 + px[:, 3] * 11) % 64
    order = np.lexsort((np.arange(n), hsh))
    last = np.full(n, -1)
    m = hsh[order[1:]] == hsh[order[:-1]]
    last[order[1:][m]] = order[:-1][m]
    hit = (last >= 0) & (px[np.maximum(last, 0)] == px).all(1)
    d = (px[:, :3] - prev[:, :3] + 128) % 256 - 128
    dg = d[:, 1]
    dr, db = d[:, 0] - dg, d[:, 2] - dg
    keep_a = px[:, 3] == prev[:, 3]
    if explicit_first:
        keep_a[0] = False
    diff = keep_a & (d >= -2).all(1) & (d <= 1).all(1)
    luma = keep_a & (dg >= -32) & (dg <= 31) & (np.abs(dr + 0.5) <= 8) & (
        np.abs(db + 0.5) <= 8)
    ops = np.zeros((n, 5), np.int64)
    size = np.zeros(n, np.int64)
    # runs: the op sits on a run's 62nd pixel and on its last
    start = same & ~np.concatenate([[False], same[:-1]])
    gid = np.cumsum(start) - 1
    first = np.append(np.flatnonzero(start), 0)
    k = np.arange(n) - first[np.maximum(gid, 0)]
    end = same & ((k % 62 == 61) | ~np.concatenate([same[1:], [False]]))
    ops[end, 0] = 0xC0 | (k[end] % 62)
    size[end] = 1
    lit = ~same
    rgba = lit & ~hit & ~keep_a
    rgb = lit & ~hit & keep_a & ~diff & ~luma
    lum = lit & ~hit & ~diff & luma
    dif = lit & ~hit & diff
    ops[lit & hit, 0] = hsh[lit & hit]
    ops[dif, 0] = 0x40 | (d[dif, 0] + 2) << 4 | (d[dif, 1] + 2) << 2 | (
        d[dif, 2] + 2)
    ops[lum, 0] = 0x80 | (dg[lum] + 32)
    ops[lum, 1] = (dr[lum] + 8) << 4 | (db[lum] + 8)
    ops[rgb, 0] = 0xFE
    ops[rgb, 1:4] = px[rgb, :3]
    ops[rgba, 0] = 0xFF
    ops[rgba, 1:5] = px[rgba]
    size[lit & hit] = size[dif] = 1
    size[lum] = 2
    size[rgb] = 4
    size[rgba] = 5
    body = ops.astype(np.uint8)[np.arange(5)[None, :] < size[:, None]]
    head = b"qoif" + struct.pack(">IIBB", w, h, channels or c, 0)
    return head + body.tobytes() + b"\0" * 7 + b"\1"


# ------------------------------------------------------------------ PSD
def psd_bytes(planes: np.ndarray, psd_mode: int, bits: int = 8,
              compression: int = 1, color_data: bytes = b"",
              resources: bytes = b"", layers: bytes = b"",
              version: int = 1) -> bytes:
    """A PSD of ``planes`` (c, h, w) stored channel bytes (packed bits at
    depth 1: (1, h, ceil(w / 8))), its composite raw or PackBits behind the
    byte counts; the colour-mode data, resources and layer section as
    given."""
    c, h, w = planes.shape[0], planes.shape[1], (
        planes.shape[2] * 8 if bits == 1 else planes.shape[2])
    out = b"8BPS" + struct.pack(">H6xHIIHH", version, c, h, w, bits, psd_mode)
    for block in (color_data, resources, layers):
        out += struct.pack(">I", len(block)) + block
    out += struct.pack(">H", compression)
    rows = [planes[k, y].astype(np.uint8).tobytes() for k in range(c)
            for y in range(h)]
    if compression == 1:
        coded = [packbits(r) for r in rows]
        out += np.array([len(r) for r in coded], ">u2").tobytes()
        rows = coded
    return out + b"".join(rows)


def psd_resource(rid: int, body: bytes, name: bytes = b"") -> bytes:
    """One image resource block (``8BIM``, its id, a padded Pascal name and
    a padded body)."""
    pname = bytes([len(name)]) + name
    pname += b"\0" * (len(pname) % 2)
    return (b"8BIM" + struct.pack(">H", rid) + pname
            + struct.pack(">I", len(body)) + body + b"\0" * (len(body) % 2))


# ------------------------------------------------------------- ICO, CUR
def dib_bytes(img: np.ndarray, bits: int, palette: Optional[np.ndarray] = None,
              alpha: Optional[np.ndarray] = None, and_mask: bool = True
              ) -> bytes:
    """An icon's DIB: ``bmp_bytes``' info header and palette with the height
    doubled, its XOR image (32 bits: BGRA, ``alpha`` the fourth byte), then
    the AND mask (1 where ``alpha`` is 0, rows padded to 32 bits)."""
    h, w = img.shape[:2]
    if bits == 32:
        a = np.zeros((h, w), np.uint8) if alpha is None else alpha
        body = np.concatenate([img[..., 2::-1], a[..., None]], -1)[::-1]
        dib = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, 32, 0,
                          len(body.tobytes()), 0, 0, 0, 0) + body.tobytes()
    else:
        full = bmp_bytes(img, bits, palette)
        dib = bytearray(full[14:])
        dib[8:12] = struct.pack("<i", 2 * h)
        dib = bytes(dib)
    if and_mask:
        wpad = w + (-w % 32)
        bits_and = np.zeros((h, wpad), np.uint8)
        if alpha is not None:
            bits_and[:, :w] = alpha == 0
        dib += np.packbits(bits_and[::-1], axis=1).tobytes()
    return dib


def icon_dir(payloads: Sequence[bytes], dims: Sequence[Tuple[int, int]],
             kind: int = 1, bpps: Optional[Sequence[int]] = None,
             colors: Optional[Sequence[int]] = None,
             hotspots: Optional[Sequence[Tuple[int, int]]] = None) -> bytes:
    """An ICO (``kind`` 1) or CUR (``kind`` 2) file of the payloads (DIBs
    or PNGs): the directory (a dimension of 256 written as 0; an icon's
    planes and bit count, a cursor's hotspot) and the payloads after it."""
    n = len(payloads)
    out = struct.pack("<HHH", 0, kind, n)
    offset = 6 + 16 * n
    for i, body in enumerate(payloads):
        w, h = dims[i]
        if kind == 1:
            a, b = 1, (bpps[i] if bpps else 32)
        else:
            a, b = hotspots[i] if hotspots else (0, 0)
        out += struct.pack("<BBBBHHII", w % 256, h % 256,
                           colors[i] if colors else 0, 0, a, b, len(body),
                           offset)
        offset += len(body)
    return out + b"".join(payloads)


# ------------------------------------------------------------- JPEG 2000
# Rewrites of an encoder's JP2 files and codestreams: boxes, marker
# segments, tile-parts cut at the packet lengths of PLT segments.
def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def boxes(data: bytes, pos: int = 0, end=None) -> list:
    end = len(data) if end is None else end
    out = []
    while pos < end:
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        n = end - pos if n == 0 else n
        out.append((kind, data[pos + 8:pos + n]))
        pos += n
    return out


def jp2_parts(jp2: bytes):
    """(jp2h sub-boxes, codestream) of a Pillow JP2 file."""
    top = dict(boxes(jp2))
    return boxes(top[b"jp2h"]), top[b"jp2c"]


def jp2_file(sub: list, code: bytes, jp2c_header: bytes = None) -> bytes:
    head = (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", b"".join(box(k, v) for k, v in sub)))
    if jp2c_header is None:
        return head + box(b"jp2c", code)
    return head + jp2c_header + code


def split_codestream(code: bytes):
    """(main header segments, [(Isot, header segments, data)])."""
    pos, main = 2, []
    while True:
        m, n = struct.unpack(">HH", code[pos:pos + 4])
        if m == 0xFF90:
            break
        main.append((m, code[pos + 4:pos + 2 + n]))
        pos += 2 + n
    parts = []
    while code[pos:pos + 2] == b"\xff\x90":
        isot, psot = struct.unpack(">HI", code[pos + 4:pos + 10])
        end = pos + psot
        q, segs = pos + 12, []
        while code[q:q + 2] != b"\xff\x93":
            m, n = struct.unpack(">HH", code[q:q + 4])
            segs.append((m, code[q + 4:q + 2 + n]))
            q += 2 + n
        parts.append((isot, segs, code[q + 2:end]))
        pos = end
    return main, parts


def seg(m: int, body: bytes) -> bytes:
    return struct.pack(">HH", m, len(body) + 2) + body


def join_codestream(main: list, parts: list) -> bytes:
    """``parts``: (Isot, TPsot, TNsot, header segments, data)."""
    out = b"\xff\x4f" + b"".join(seg(m, b) for m, b in main)
    for isot, tp, tn, segs, data in parts:
        head = b"".join(seg(m, b) for m, b in segs)
        out += (b"\xff\x90" + struct.pack(">HHIBB", 10, isot,
                                          12 + len(head) + 2 + len(data), tp,
                                          tn) + head + b"\xff\x93" + data)
    return out + b"\xff\xd9"


def packet_lengths(segs: list) -> list:
    """The Iplt lengths of a tile-part's PLT segments."""
    out = []
    for m, b in segs:
        if m != 0xFF58:
            continue
        v = 0
        for byte in b[1:]:
            v = (v << 7) | (byte & 0x7F)
            if not byte & 0x80:
                out.append(v)
                v = 0
    return out


def packets(data: bytes, lengths: list) -> list:
    out, pos = [], 0
    for n in lengths:
        out.append(data[pos:pos + n])
        pos += n
    assert pos == len(data)
    return out


def with_sop(code: bytes) -> bytes:
    """A SOP marker before every packet (and Scod's SOP bit)."""
    main, parts = split_codestream(code)
    main = [(m, bytes([b[0] | 2]) + b[1:]) if m == 0xFF52 else (m, b)
            for m, b in main]
    out = []
    for isot, segs, data in parts:
        body = b"".join(b"\xff\x91" + struct.pack(">HH", 4, k & 0xFFFF) + p
                        for k, p in enumerate(packets(
                            data, packet_lengths(segs))))
        out.append((isot, 0, 1, [s for s in segs if s[0] != 0xFF58], body))
    return join_codestream(main, out)


def split_tile_parts(code: bytes, n: int, interleave: bool = False) -> bytes:
    """Each tile in ``n`` tile-parts cut at packet boundaries; with
    ``interleave``, the tiles' parts alternate in the stream."""
    main, parts = split_codestream(code)
    per_tile = []
    for isot, segs, data in parts:
        pk = packets(data, packet_lengths(segs))
        cuts = np.array_split(np.arange(len(pk)), n)
        per_tile.append([(isot, i, n, [], b"".join(pk[j] for j in c))
                         for i, c in enumerate(cuts)])
    if interleave:
        out = [p for i in range(n) for t in per_tile for p in t[i:i + 1]]
    else:
        out = [p for t in per_tile for p in t]
    return join_codestream(main, out)


def with_precision(code: bytes, prec: int, sgnd: int = 0) -> bytes:
    main, parts = split_codestream(code)
    out = []
    for m, b in main:
        if m == 0xFF51:
            csiz = struct.unpack(">H", b[34:36])[0]
            comps = b"".join(bytes([((prec - 1) | (sgnd << 7)), b[37 + 3 * i],
                                    b[38 + 3 * i]]) for i in range(csiz))
            b = b[:36] + comps
        out.append((m, b))
    return join_codestream(out, [(i, 0, 1, s, d) for i, s, d in parts])


def rewrite_jp2(jp2: bytes, code: bytes = None, colr: int = None,
                bpc: int = None, nc: int = None, extra: list = ()) -> bytes:
    sub, old = jp2_parts(jp2)
    out = []
    for k, v in sub:
        if k == b"ihdr":
            h, w, n, b = struct.unpack(">IIHB", v[:11])
            v = struct.pack(">IIHB", h, w, nc or n, b if bpc is None else bpc
                            ) + v[11:]
        elif k == b"colr" and colr is not None:
            v = v[:3] + struct.pack(">I", colr)
        out.append((k, v))
    return jp2_file(out + list(extra), old if code is None else code)


def pclr_box(entries: np.ndarray) -> bytes:
    ne, npc = entries.shape
    return (struct.pack(">HB", ne, npc) + bytes([7] * npc)
            + entries.astype(np.uint8).tobytes())




def tile_mosaic(code: bytes, nx: int, ny: int) -> bytes:
    """A one-tile codestream's tile-part repeated ``nx`` x ``ny`` times
    over a grid of its tile size (SIZ rewritten): valid where the tile
    size keeps every tile's code-blocks and parities the first tile's."""
    main, parts = split_codestream(code)
    (isot, segs, data), = parts
    siz = dict(main)[0xFF51]
    xt, yt = struct.unpack(">II", siz[18:26])
    assert struct.unpack(">IIII", siz[2:18]) == (xt, yt, 0, 0)
    siz = siz[:2] + struct.pack(">IIII", xt * nx, yt * ny, 0, 0) + siz[18:]
    main = [(m, siz if m == 0xFF51 else b) for m, b in main]
    return join_codestream(main, [(k, 0, 1, [], data)
                                  for k in range(nx * ny)])


# ------------------------------------------------- the rest of Image.ID
# IM, IMT, SUN (raw and run-length), ICNS (run-length channels, masks,
# payloads), GBR, FLI (COLOR, BLACK, BRUN, COPY, LC, SS2), FITS (gzip too),
# MCIDAS, PIXAR, SPIDER, MSP (v2 rows), XBM, XPM, XVTHUMB, PCD, DCX, FTEX,
# BLP (palette, DXT blocks, JPEG) and IPTC files, for the layouts Pillow
# cannot write and for ``chip_smoke.py``.
def im_bytes(body: bytes, image_type: str, size: Tuple[int, int],
             lut: Optional[bytes] = None, extra: Sequence[str] = ()) -> bytes:
    """An IM file: header lines (``Image type: {image_type}``), zeros to
    byte 511, 0x1A, the 768-byte ``lut`` where given, then ``body`` (rows
    bottom to top, as the caller laid them out)."""
    lines = [f"Image type: {image_type}", "Name: written.im",
             f"Image size (x*y): {size[0]}*{size[1]}",
             "File size (no of images): 1", *extra]
    if lut is not None:
        lines.append("Lut: 1")
    head = "".join(f"{ln}\r\n" for ln in lines).encode("latin-1")
    head += b"\0" * (511 - len(head)) + b"\x1a"
    return head + (lut or b"") + body


def im_rgb_bytes(rgb: np.ndarray) -> bytes:
    """An IM ``RGB image`` (rawmode ``RGB;L``: each row's R, G and B planes
    in turn, rows bottom to top) of (h, w, 3) uint8."""
    h, w, _ = rgb.shape
    body = rgb[::-1].transpose(0, 2, 1).astype(np.uint8).tobytes()
    return im_bytes(body, "RGB image", (w, h))


def imt_bytes(gray: np.ndarray, comment: bytes = b"* an IM Tools file") -> bytes:
    h, w = gray.shape
    return (comment + b"\nwidth %d\nheight %d\npixel n8\n\x0c" % (w, h)
            + gray.astype(np.uint8).tobytes())


def sun_rle(data: bytes) -> bytes:
    """SUN's byte runs: 0x80 n v for runs of 3 to 256 (and any 0x80 run),
    0x80 0 for one 0x80, the byte itself otherwise."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 255:
            j += 1
        k, v = j - i + 1, data[i]
        if k >= 3 or v == 0x80:
            out += bytes([0x80, k - 1, v]) if k > 1 else b"\x80\x00"
        else:
            out += bytes([v]) * k
        i = j + 1
    return bytes(out)


def sun_bytes(rows: np.ndarray, w: int, depth: int, ftype: int = 1,
              palette: Optional[np.ndarray] = None) -> bytes:
    """A Sun raster of ``rows`` (h, ceil(w * depth / 8)) stored bytes
    (BGR for 24/32 bits unless ``ftype`` 3): type 2 run-length codes the
    rows joined (not padded), the others pad each row to 16 bits; a
    ``palette`` (n, 3) is stored as three planes."""
    h = rows.shape[0]
    pal = b"" if palette is None else np.asarray(
        palette, np.uint8).T.tobytes()
    if ftype == 2:
        body = sun_rle(rows.astype(np.uint8).tobytes())
    else:
        stride = ((w * depth + 15) // 16) * 2
        pad = np.zeros((h, stride - rows.shape[1]), np.uint8)
        body = np.concatenate([rows.astype(np.uint8), pad], 1).tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype,
                       1 if len(pal) else 0, len(pal)) + pal + body


def icns_runs(data: bytes) -> bytes:
    """ICNS's channel runs: 0x80 + (k - 3) v for runs of 3 to 130, else
    literals of up to 128 bytes behind ``k - 1``."""
    out, i, n = bytearray(), 0, len(data)
    lit = bytearray()

    def flush():
        while lit:
            part = lit[:128]
            out.extend(bytes([len(part) - 1]) + part)
            del lit[:128]

    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 129:
            j += 1
        k = j - i + 1
        if k >= 3:
            flush()
            out += bytes([0x80 + k - 3, data[i]])
        else:
            lit.extend(data[i:j + 1])
        i = j + 1
    flush()
    return bytes(out)


def icns_channels(rgb: np.ndarray, sig: bool = False) -> bytes:
    """The three run-length channels of (h, w, 3) uint8 (``it32``'s four
    zero bytes first where ``sig``)."""
    body = b"".join(icns_runs(rgb[..., k].astype(np.uint8).tobytes())
                    for k in range(3))
    return (b"\0\0\0\0" if sig else b"") + body


def icns_bytes(blocks: Sequence[Tuple[bytes, bytes]]) -> bytes:
    body = b"".join(t + struct.pack(">I", 8 + len(p)) + p for t, p in blocks)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def gbr_bytes(img: np.ndarray, version: int = 2, comment: bytes = b"brush",
              spacing: int = 25) -> bytes:
    """A GIMP brush of (h, w) ``L`` or (h, w, 4) ``RGBA`` bytes."""
    h, w = img.shape[:2]
    depth = 1 if img.ndim == 2 else 4
    comment += b"\0"
    if version == 1:
        head = struct.pack(">5I", 20 + len(comment), 1, w, h, depth)
    else:
        head = struct.pack(">5I", 28 + len(comment), 2, w, h, depth) + \
            b"GIMP" + struct.pack(">I", spacing)
    return head + comment + img.astype(np.uint8).tobytes()


def fli_brun(img: np.ndarray) -> bytes:
    """BRUN lines: a packet count byte (ignored), then runs (k, v) of up to
    127 and literals (256 - k, bytes) of up to 128."""
    out = bytearray()
    for row in img.astype(np.uint8):
        out.append(0)
        i, n = 0, len(row)
        while i < n:
            j = i
            while j + 1 < n and row[j + 1] == row[i] and j - i < 126:
                j += 1
            if j > i:
                out += bytes([j - i + 1, row[i]])
                i = j + 1
                continue
            j = i + 1
            while j < n and j - i < 128 and not (j + 1 < n
                                                 and row[j + 1] == row[j]):
                j += 1
            out += bytes([256 - (j - i)]) + row[i:j].tobytes()
            i = j
    return bytes(out)


def fli_lc(y0: int, rows: Sequence[Sequence[Tuple[int, bytes]]]) -> bytes:
    """An LC chunk body: from line ``y0``, each line's packets (skip,
    bytes); a bytes of one repeated value of length >= 3 goes as a run."""
    out = bytearray(struct.pack("<HH", y0, len(rows)))
    for packets in rows:
        out.append(len(packets))
        for skip, data in packets:
            if len(data) >= 3 and len(set(data)) == 1:
                out += bytes([skip, 256 - len(data), data[0]])
            else:
                out += bytes([skip, len(data)]) + data
    return bytes(out)


def fli_ss2(lines: Sequence[Tuple[int, Sequence[Tuple[int, bytes]], Optional[int]]]) -> bytes:
    """An SS2 chunk body: each line (lines to skip first, packets (skip,
    bytes of whole words; one repeated word goes as a run), the last byte of
    an odd width or None)."""
    out = bytearray(struct.pack("<H", len(lines)))
    for skip_lines, packets, last in lines:
        if skip_lines:
            out += struct.pack("<H", 65536 - skip_lines)
        if last is not None:
            out += struct.pack("<H", 0x8000 | last)
        out += struct.pack("<H", len(packets))
        for skip, data in packets:
            words = {data[k:k + 2] for k in range(0, len(data), 2)}
            if len(data) >= 4 and len(words) == 1:
                out += bytes([skip, 256 - len(data) // 2]) + data[:2]
            else:
                out += bytes([skip, len(data) // 2]) + data
    return bytes(out)


def fli_chunk(kind: int, body: bytes) -> bytes:
    if len(body) % 2:
        body += b"\0"
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_color(palette: np.ndarray, kind: int = 4, skip: int = 0) -> bytes:
    """A COLOR chunk (4: 8-bit, 11: 6-bit values) of one packet."""
    n = len(palette)
    return fli_chunk(kind, struct.pack("<HBB", 1, skip, n % 256)
                     + np.asarray(palette, np.uint8).tobytes())


def fli_bytes(w: int, h: int, chunks: Sequence[bytes], magic: int = 0xAF12,
              frames: int = 1) -> bytes:
    """An FLI/FLC file of one frame of ``chunks`` (each from
    ``fli_chunk``)."""
    frame = b"".join(chunks)
    frame = struct.pack("<IHH8x", 16 + len(frame), 0xF1FA, len(chunks)) + \
        frame
    head = struct.pack("<IHHHHHHI", 128 + len(frame), magic, frames, w, h,
                       8, 0, 5)
    head = head.ljust(128, b"\0")
    return head + frame


def fits_bytes(img: np.ndarray, bitpix: int, gzip_words: bool = False,
               naxis1_only: bool = False) -> bytes:
    """A FITS primary image (``img`` rows stored as given: Pillow reads
    them bottom to top) of big-endian ``bitpix`` values; or, with
    ``gzip_words``, an empty primary unit and a ``BINTABLE`` extension
    whose gzip stream holds one 4-byte big-endian word a pixel."""
    def card(k, v):
        return f"{k:<8}= {v:>20}".ljust(80).encode()

    def unit(cards):
        s = b"".join(cards) + b"END".ljust(80)
        return s.ljust(-(-len(s) // 2880) * 2880, b" ")

    h, w = img.shape
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    if not gzip_words:
        axes = [card("NAXIS", 1), card("NAXIS1", h * w)] if naxis1_only \
            else [card("NAXIS", 2), card("NAXIS1", w), card("NAXIS2", h)]
        body = img.astype(dt).tobytes()
        return unit([card("SIMPLE", "T"), card("BITPIX", bitpix)] + axes) \
            + body.ljust(-(-len(body) // 2880) * 2880, b"\0")
    import gzip as _gzip
    words = _gzip.compress(img.astype(">i4").tobytes(), mtime=0)
    table = bytes(8)
    return (unit([card("SIMPLE", "T"), card("BITPIX", 8), card("NAXIS", 0)])
            + unit([card("XTENSION", "'BINTABLE'"), card("BITPIX", 8),
                    card("NAXIS", 2), card("NAXIS1", 8), card("NAXIS2", 1),
                    card("ZIMAGE", "T"), card("ZCMPTYPE", "'GZIP_1  '"),
                    card("ZBITPIX", bitpix), card("ZNAXIS", 2),
                    card("ZNAXIS1", w), card("ZNAXIS2", h)])
            + table + words)


def mcidas_bytes(img: np.ndarray, nbytes: int, prefix: int = 0) -> bytes:
    """A McIdas area of (h, w) values of ``nbytes`` big-endian bytes, each
    row behind ``prefix`` bytes."""
    h, w = img.shape
    words = [0] * 64
    words[1] = 4
    words[8], words[9], words[10], words[13], words[14] = h, w, nbytes, 1, \
        prefix
    words[33] = 256
    head = struct.pack("!64i", *words)
    dt = {1: ">u1", 2: ">u2", 4: ">u4"}[nbytes]
    rows = img.astype(dt).view(np.uint8).reshape(h, w * nbytes)
    rows = np.concatenate([np.full((h, prefix), 7, np.uint8), rows], 1)
    return head + rows.tobytes()


def pixar_bytes(rgb: np.ndarray) -> bytes:
    h, w, _ = rgb.shape
    head = bytearray(1024)
    head[:4] = b"\200\350\000\000"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + rgb.astype(np.uint8).tobytes()


def spider_bytes(img: np.ndarray, big: bool = True, stack: bool = False
                 ) -> bytes:
    """A SPIDER 2D image (or a stack of one) of (h, w) float32."""
    h, w = img.shape
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    hdr = [0.0] * (labbyt // 4)
    hdr[0], hdr[1], hdr[2], hdr[4], hdr[11] = 1.0, h, h, 1.0, w
    hdr[12], hdr[21], hdr[22] = labrec, labbyt, lenbyt
    if stack:
        hdr[23], hdr[25] = 2.0, 1.0
    f = ">f4" if big else "<f4"
    head = np.array(hdr, f).tobytes()
    body = img.astype(f).tobytes()
    if stack:
        inner = list(hdr)
        inner[23], inner[26] = 0.0, 1.0
        return head + np.array(inner, f).tobytes() + body
    return head + body


def msp_bytes(bits: np.ndarray, v2: bool = True) -> bytes:
    """An MSP of (h, ceil(w / 8)) packed rows and width ``w`` in
    ``bits.shape`` terms: v1 raw, v2 run-length rows (all-white rows
    empty)."""
    h, nb = bits.shape
    w = nb * 8
    words = [0] * 16
    words[0], words[1] = struct.unpack("<HH", b"LinS" if v2 else b"DanM")
    words[2], words[3], words[4], words[5], words[6], words[7] = \
        w, h, 1, 1, 1, 1
    words[8], words[9] = w, h
    x = 0
    for v in words:
        x ^= v
    words[12] = x
    head = struct.pack("<16H", *words)
    if not v2:
        return head + bits.astype(np.uint8).tobytes()
    rows = []
    for row in bits.astype(np.uint8):
        if (row == 0xFF).all():
            rows.append(b"")
            continue
        out, i = bytearray(), 0
        while i < nb:
            j = i
            while j + 1 < nb and row[j + 1] == row[i] and j - i < 254:
                j += 1
            if j - i >= 2:
                out += bytes([0, j - i + 1, row[i]])
                i = j + 1
            else:
                k = min(nb - i, 255)
                out += bytes([k]) + row[i:i + k].tobytes()
                i += k
        rows.append(bytes(out))
    return head + struct.pack(f"<{h}H", *map(len, rows)) + b"".join(rows)


def xbm_bytes(bits: np.ndarray, w: int, hotspot=None) -> bytes:
    """An XBM of (h, ceil(w / 8)) bytes (least significant bit first)."""
    h = bits.shape[0]
    s = f"#define im_width {w}\n#define im_height {h}\n"
    if hotspot:
        s += f"#define im_x_hot {hotspot[0]}\n#define im_y_hot {hotspot[1]}\n"
    vals = [f"0x{v:02X}" if k % 3 else f"0x{v:02x}"
            for k, v in enumerate(bits.reshape(-1).tolist())]
    body = ",\n".join(", ".join(vals[i:i + 12]) for i in range(0, len(vals),
                                                                12))
    return (s + "static char im_bits[] = {\n" + body + "\n};\n").encode()


def xpm_bytes(idx: np.ndarray, colours: Sequence[Optional[Tuple[int, int, int]]],
              cpp: int = 1) -> bytes:
    """An XPM of (h, w) indices into ``colours`` (an RGB triple, or None
    for ``c None``), keys of ``cpp`` characters."""
    h, w = idx.shape
    chars = "".join(chr(c) for c in range(35, 127) if chr(c) not in '"\\')
    keys = []
    for k in range(len(colours)):
        key, v = "", k
        for _ in range(cpp):
            key += chars[v % len(chars)]
            v //= len(chars)
        keys.append(key)
    lines = ["/* XPM */", "static char *im[] = {", "/* w h ncolors cpp */",
             f'"{w} {h} {len(colours)} {cpp}",']
    for key, c in zip(keys, colours):
        val = "None" if c is None else "#%02x%02x%02x" % tuple(c)
        lines.append(f'"{key} c {val}",')
    lines.append("/* pixels */")
    for row in idx:
        lines.append('"' + "".join(keys[v] for v in row) + '",')
    lines.append("};")
    return ("\n".join(lines) + "\n").encode()


def xvthumb_bytes(idx: np.ndarray) -> bytes:
    h, w = idx.shape
    return (b"P7 332\n#XVVERSION:Version 2.28\n#END_OF_COMMENTS\n%d %d 255\n"
            % (w, h)) + idx.astype(np.uint8).tobytes()


def pcd_bytes(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
              orientation: int = 0) -> bytes:
    """A PhotoCD base image: (512, 768) luma, (256, 384) Cb and Cr."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    pairs = np.concatenate([y.reshape(256, 2 * 768), cb, cr], 1)
    return bytes(head) + pairs.astype(np.uint8).tobytes()


def dcx_bytes(frames: Sequence[bytes]) -> bytes:
    offsets, pos = [], 4 + 4 * (len(frames) + 1)
    for f in frames:
        offsets.append(pos)
        pos += len(f)
    return struct.pack(f"<I{len(frames) + 1}I", 0x3ADE68B1, *offsets, 0) + \
        b"".join(frames)


def ftex_bytes(w: int, h: int, fmt: int, body: bytes) -> bytes:
    return (b"FTEX" + struct.pack("<6i", 1, w, h, 1, 1, fmt)
            + struct.pack("<i", 32) + struct.pack("<i", len(body)) + body)


def blp2_bytes(w: int, h: int, encoding: int, alpha_depth: int,
               alpha_encoding: int, body: bytes,
               palette: Optional[np.ndarray] = None) -> bytes:
    """A BLP2 of mip 0 ``body`` after a 256-entry BGRA ``palette``."""
    pal = np.zeros((256, 4), np.uint8) if palette is None else palette
    head = b"BLP2" + struct.pack("<ibbbbII", 1, encoding, alpha_depth,
                                 alpha_encoding, 0, w, h)
    offset = len(head) + 128 + 1024
    return (head + struct.pack("<16I", offset, *[0] * 15)
            + struct.pack("<16I", len(body), *[0] * 15)
            + np.asarray(pal, np.uint8).tobytes() + body)


def blp1_jpeg_bytes(w: int, h: int, jpeg: bytes, split: int,
                    alpha: int = 0) -> bytes:
    """A BLP1 whose JPEG is its first ``split`` bytes as the header's tables
    and the rest as mip 0."""
    head = b"BLP1" + struct.pack("<iIIIii", 0, alpha, w, h, 5, 0)
    tables, data = jpeg[:split], jpeg[split:]
    offset = len(head) + 128 + 4 + len(tables) + 6  # 6 bytes of gap
    return (head + struct.pack("<16I", offset, *[0] * 15)
            + struct.pack("<16I", len(data), *[0] * 15)
            + struct.pack("<I", len(tables)) + tables + b"\0" * 6 + data)


def iptc_field(record: int, dataset: int, body: bytes) -> bytes:
    if len(body) < 0x8000:
        return bytes([0x1C, record, dataset]) + struct.pack(">H", len(body)) \
            + body
    return bytes([0x1C, record, dataset]) + struct.pack(">HI", 0x8004,
                                                        len(body)) + body


def iptc_bytes(data: bytes, size: Tuple[int, int], layers: int,
               component: int, band: Optional[int] = None,
               compression: int = 1, chunk: int = 500) -> bytes:
    """An IPTC/NAA file of image ``data`` (raw bytes or a file) in image
    fields of ``chunk`` bytes."""
    w, h = size
    out = iptc_field(1, 90, b"\x1b%G") + iptc_field(2, 5, b"a name")
    out += iptc_field(3, 20, struct.pack(">H", w)) + iptc_field(
        3, 30, struct.pack(">H", h))
    out += iptc_field(3, 60, bytes([layers, component]))
    if band is not None:
        out += iptc_field(3, 65, bytes([band]))
    out += iptc_field(3, 120, bytes([compression]))
    for k in range(0, len(data), chunk):
        out += iptc_field(8, 10, data[k:k + chunk])
    return out + b"\0" * 5
