"""A baseline JPEG reader on numpy, giving what Pillow's
``Image.open(p).convert("RGB")`` gives (libjpeg-turbo's default decode).

Reads sequential DCT JPEGs with Huffman coding (SOF0, and SOF1 at 8 bits),
8-bit, with 1 component (returned as ``L``) or 3 (YCbCr, returned as
``RGB``) at sampling 4:4:4, 4:2:2 or 4:2:0, in one interleaved scan or in
one scan a component, with or without restart intervals (DRI / RSTn);
APPn and COM segments are skipped, and no EXIF rotation is applied
(``convert`` applies none).  To give libjpeg-turbo's bits it repeats:

  * the integer "islow" inverse DCT (``jidctint.c``: 13-bit constants, two
    passes with 2 extra bits between them, rounded shifts), over every block
    at once, and the post-IDCT clamp to [0, 255];
  * the "fancy" (triangle) upsampling of the chroma planes, ``h2v1`` and
    ``h2v2`` (``jdsample.c``: 3/4 and 1/4 weights, the edges replicated, its
    alternating +1/+2 and +8/+7 rounding biases); with fancy upsampling on,
    ``jdmaster.c`` never takes the merged upsampler;
  * the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` (16 fraction bits).

Anything else raises ``ValueError`` naming the file and what it found:
progressive, lossless, hierarchical or arithmetic-coded frames, 12-bit
samples, CMYK or Adobe RGB, and other sampling layouts.  The Huffman stage
is the one per-symbol Python loop: each symbol is found by a table lookup on
a peeked 16-bit window of the bit stream (code, run and the coefficient's
extra bits in one step where they fit), not bit by bit.
"""
from __future__ import annotations

import re
from array import array
from typing import Dict, List, Tuple

import numpy as np

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
# the end of an entropy-coded segment: a marker other than a stuffed 0 byte
# or a restart marker
_SEG_END = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RST = re.compile(rb"\xff[\xd0-\xd7]")


class _Unsupported(ValueError):
    pass


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
            if code >= 1 << L:
                raise _Unsupported("a Huffman table that overflows its codes")
            lo = code << (16 - L)
            hi = (code + 1) << (16 - L)
            length[lo:hi] = L
            symbol[lo:hi] = symbols[k]
            code += 1
            k += 1
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


# -------------------------------------------------------------- the IDCT
_CONST_BITS, _PASS1_BITS = 13, 2
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


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
    """(N, 64) natural-order coefficients -> (N, 8, 8) uint8 samples."""
    out = np.empty((coef.shape[0], 8, 8), np.uint8)
    step = 16384
    for lo in range(0, coef.shape[0], step):
        blk = (coef[lo:lo + step].astype(np.int64) * quant).reshape(-1, 8, 8)
        # pass 1: columns (axis 1 is the row index within each column)
        ws = _idct_1d(blk, _CONST_BITS - _PASS1_BITS)
        # pass 2: rows
        px = _idct_1d(ws.transpose(0, 2, 1), _CONST_BITS + _PASS1_BITS + 3)
        out[lo:lo + step] = np.clip(px.transpose(0, 2, 1) + 128, 0, 255)
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


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """``ycc_rgb_convert`` with ``build_ycc_rgb_table``'s fixed point."""
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


# ------------------------------------------------------------- decoding
class _Frame:
    def __init__(self, kind: int, body: bytes):
        precision, self.h, self.w, n = (body[0], int.from_bytes(body[1:3], "big"),
                                        int.from_bytes(body[3:5], "big"), body[5])
        if kind not in (0xC0, 0xC1):
            raise _Unsupported(f"a {_SOF_KINDS.get(kind, hex(kind))} frame "
                               f"(SOF{kind - 0xC0})")
        if precision != 8:
            raise _Unsupported(f"{precision}-bit samples (SOF{kind - 0xC0})")
        if self.h == 0 or self.w == 0:
            raise _Unsupported("a frame without its height (DNL)")
        self.ids, self.hv, self.tq = [], [], []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            self.ids.append(cid)
            self.hv.append((hv >> 4, hv & 15))
            self.tq.append(tq)
        self.hmax = max(h for h, _ in self.hv)
        self.vmax = max(v for _, v in self.hv)
        self.mcux = -(-self.w // (8 * self.hmax))
        self.mcuy = -(-self.h // (8 * self.vmax))
        # each component's block grid, padded to whole MCUs
        self.nbx = [self.mcux * h for h, _ in self.hv]
        self.nby = [self.mcuy * v for _, v in self.hv]
        self.base = np.cumsum([0] + [x * y * 64 for x, y in
                                     zip(self.nbx, self.nby)]).tolist()
        self.coef = np.zeros(self.base[-1], np.int32)


def _decode_scan(frame: _Frame, comps: List[int], tables: Dict, restart: int,
                 data: bytes) -> None:
    """Entropy-decode one scan's segment(s) into ``frame.coef``."""
    # split at the restart markers first: a stuffed 0xFF 0x00 may be
    # followed by a byte that looks like one
    segments = [s.replace(b"\xff\x00", b"\xff") for s in _RST.split(data)]
    zz = _ZIGZAG.tolist()
    idx, val = array("q"), array("i")
    put_i, put_v = idx.append, val.append
    if len(comps) == 1:
        ci = comps[0]
        h, v = frame.hv[ci]
        # a non-interleaved scan covers the component's own blocks only
        cw = -(-frame.w * h // frame.hmax)
        ch = -(-frame.h * v // frame.vmax)
        units = [[(ci, frame.base[ci] + (by * frame.nbx[ci] + bx) * 64)]
                 for by in range(-(-ch // 8)) for bx in range(-(-cw // 8))]
    else:
        units = []
        for my in range(frame.mcuy):
            for mx in range(frame.mcux):
                unit = []
                for ci in comps:
                    h, v = frame.hv[ci]
                    for yy in range(v):
                        for xx in range(h):
                            unit.append((ci, frame.base[ci] + (
                                (my * v + yy) * frame.nbx[ci] + mx * h + xx) * 64))
                units.append(unit)
    luts = {ci: tables[ci] for ci in comps}
    pred = {ci: 0 for ci in comps}
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
            pred = {ci: 0 for ci in comps}
        for ci, base in unit:
            dc, ac = luts[ci]
            # DC: the difference from the component's last DC value
            nb, _, diff, extra = dc[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not nb:
                raise _Unsupported("a corrupt Huffman code (DC)")
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
                    raise _Unsupported("a corrupt Huffman code (AC)")
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
    if len(idx):
        frame.coef[np.frombuffer(idx, np.int64)] = np.frombuffer(val, np.int32)


def _planes(frame: _Frame, quant: Dict[int, np.ndarray]) -> List[np.ndarray]:
    """Each component's samples, cropped to its own size."""
    out = []
    for ci, (h, v) in enumerate(frame.hv):
        nbx, nby = frame.nbx[ci], frame.nby[ci]
        if frame.tq[ci] not in quant:
            raise _Unsupported(f"component {ci} names a missing "
                               f"quantisation table {frame.tq[ci]}")
        coef = frame.coef[frame.base[ci]:frame.base[ci + 1]].reshape(-1, 64)
        blocks = _idct_blocks(coef, quant[frame.tq[ci]])
        plane = blocks.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(
            nby * 8, nbx * 8)
        cw = -(-frame.w * h // frame.hmax)
        ch = -(-frame.h * v // frame.vmax)
        out.append(plane[:ch, :cw])
    return out


def _decode(data: bytes):
    if data[:2] != b"\xff\xd8":
        raise _Unsupported("not a JPEG file (no SOI)")
    pos, frame = 2, None
    quant: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], List[tuple]] = {}
    restart, adobe = 0, None
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
        body, pos = data[pos + 2:pos + n], pos + n
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                width = 2 if pq else 1
                vals = np.frombuffer(body[i + 1:i + 1 + 64 * width],
                                     ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = vals
                quant[tq] = q
                i += 1 + 64 * width
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                m = sum(counts)
                huff[(tc, th)] = _lookup(counts, list(body[i + 17:i + 17 + m]),
                                         ac=tc == 1)
                i += 17 + m
        elif marker == 0xDD:  # DRI
            restart = int.from_bytes(body[:2], "big")
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if frame is not None:
                raise _Unsupported("more than one frame")
            frame = _Frame(marker, body)
            ncomp = len(frame.ids)
            if ncomp == 4:
                raise _Unsupported("4 components (CMYK / YCCK)")
            if ncomp not in (1, 3):
                raise _Unsupported(f"{ncomp} components")
            if ncomp == 3 and (adobe == 0 or frame.ids == [82, 71, 66]):
                raise _Unsupported("RGB-coded components (Adobe transform 0)")
        elif marker == 0xCC:
            raise _Unsupported("arithmetic coding conditioning (DAC)")
        elif marker == 0xDC:
            raise _Unsupported("a DNL marker")
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise _Unsupported("a scan before its frame")
            ns = body[0]
            comps, tables = [], {}
            for j in range(ns):
                cid, t = body[1 + 2 * j], body[2 + 2 * j]
                ci = frame.ids.index(cid)
                comps.append(ci)
                if (0, t >> 4) not in huff or (1, t & 15) not in huff:
                    raise _Unsupported("a scan naming a missing Huffman table")
                tables[ci] = (huff[(0, t >> 4)], huff[(1, t & 15)])
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise _Unsupported("a scan that is not sequential (Ss, Se, "
                                   f"Ah/Al = {ss}, {se}, {a})")
            m = _SEG_END.search(data, pos)
            end = m.start() if m else len(data)
            _decode_scan(frame, comps, tables, restart, data[pos:end])
            pos = end
    if frame is None:
        raise _Unsupported("no frame")
    return frame, quant


def read_jpeg(path: str):
    """``(array, mode)``: ``(H, W, 3)`` uint8 ``RGB`` or ``(H, W)`` ``L``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        frame, quant = _decode(data)
        planes = _planes(frame, quant)
        if len(planes) == 1:
            return planes[0], "L"
        (h0, v0), hv = frame.hv[0], frame.hv
        if (h0, v0) != (frame.hmax, frame.vmax):
            raise _Unsupported(f"sampling {hv}: luma below the chroma")
        up = []
        for ci, plane in enumerate(planes):
            factor = (frame.hmax // hv[ci][0], frame.vmax // hv[ci][1])
            if frame.hmax % hv[ci][0] or frame.vmax % hv[ci][1]:
                factor = None
            if factor == (1, 1):
                up.append(plane)
            elif factor == (2, 1):
                up.append(_fancy_h2v1(plane))
            elif factor == (2, 2):
                up.append(_fancy_h2v2(plane))
            else:
                raise _Unsupported(f"sampling factors {hv} (only 4:4:4, "
                                   "4:2:2 and 4:2:0 are read)")
        y, cb, cr = (p[:frame.h, :frame.w] for p in up)
        return _ycc_to_rgb(y, cb, cr), "RGB"
    except _Unsupported as e:
        raise ValueError(f"{path}: unsupported JPEG: {e}") from None
