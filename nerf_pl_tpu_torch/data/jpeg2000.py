"""A JPEG 2000 reader: what Pillow's ``Jpeg2KImagePlugin`` gives for a JP2
file or a raw codestream, which Pillow decodes through OpenJPEG (2.5).

``open_jpeg2000`` is ``Jpeg2KImageFile._open``: a codestream's size is
``Xsiz - XOsiz`` by ``Ysiz - YOsiz`` and its mode comes from ``Csiz`` and
the first ``Ssiz``; a JP2 file's comes from its ``jp2h`` box (``ihdr``;
``colr`` method 1 with enumerated space 12 on 4 components is ``CMYK``;
``pclr`` on ``L``/``LA`` with entries of at most 8 bits is ``P``/``PA``,
its palette built through ``ImagePalette.getcolor``, which drops repeated
colours, so an index may point elsewhere), walked with Pillow's
``BoxReader`` (``XLBox`` lengths; a box that runs past its parent raises
``SyntaxError``, which moves ``Image.open`` on to the next format).

``load_jpeg2000`` decodes the codestream (``jp2c`` for a JP2 file) tile by
tile: markers in Python (``data/j2k_codestream.py``), then the C++ stages
of ``csrc/j2k_decode.cpp`` (built with g++ at first use through
``data/native.py``, with floating-point contraction off): tier-2, tier-1,
dequantisation and the inverse DWT, the inverse MCT with the DC shift and
clamp, as OpenJPEG computes them, bit for bit.  Each tile is unpacked into
Pillow's mode as ``Jpeg2KDecode.c``'s ``j2ku_*`` functions do: each sample
plus half the signed range (for a signed component) and a rounding half,
shifted to 8 (or for ``I;16``, 16) bits in unsigned C arithmetic, then
truncated to the pixel's width; sYCC (``colr`` 18) through Pillow's
``ImagingConvertYCbCr2RGB``; palette indices as they are (Pillow does not
apply ``pclr``, nor ``cdef``).  Where Pillow refuses the file (a colour
space without an unpacker for the mode, a tile outside the image, a
component count other than the header's) the port raises ``ValueError``
naming the file; so does a layout the port does not read
(``j2k_codestream.Unsupported``).  As in Pillow, a tile is held inside the
opened size before its data is decoded.
"""
from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from . import j2k_codestream as cs
from . import j2k_plain, native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "j2k_decode.cpp"
EXTRA_FLAGS = ("-ffp-contract=off",)
_JP2 = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
_SOC_SIZ = b"\xff\x4f\xff\x51"
# OpenJPEG's colour spaces from a colr box's enumerated space; any other
# space, an ICC profile or no colr box leaves it unspecified
_SRGB, _GRAY, _SYCC, _EYCC, _CMYK, _UNSPECIFIED = range(6)
_ENUMCS = {16: _SRGB, 17: _GRAY, 18: _SYCC, 24: _EYCC, 12: _CMYK}
# Jpeg2KDecode.c's j2k_unpackers: (mode, colour space, components) -> kind
_UNPACKERS = {
    ("L", _GRAY, 1): "gray", ("P", _SRGB, 1): "gray", ("PA", _SRGB, 2): "la",
    ("I;16", _GRAY, 1): "i16", ("I;16B", _GRAY, 1): "i16",
    ("LA", _GRAY, 2): "la", ("RGB", _GRAY, 1): "gray_rgb",
    ("RGB", _GRAY, 2): "gray_rgb", ("RGB", _SRGB, 3): "rgb",
    ("RGB", _SYCC, 3): "ycc", ("RGB", _SRGB, 4): "rgb",
    ("RGB", _SYCC, 4): "ycc", ("RGBA", _GRAY, 1): "gray_rgb",
    ("RGBA", _GRAY, 2): "la", ("RGBA", _SRGB, 3): "rgb",
    ("RGBA", _SYCC, 3): "ycc", ("RGBA", _GRAY, 4): "rgba",
    ("RGBA", _SRGB, 4): "rgba",
    ("RGBA", _SYCC, 4): "ycca", ("CMYK", _CMYK, 4): "rgba"}

_lock = threading.Lock()
_lib = None


def accept(prefix: bytes) -> bool:
    """``Jpeg2KImagePlugin._accept``."""
    return prefix[:4] == _SOC_SIZ or prefix[:12] == _JP2


# ------------------------------------------------------------------ boxes
class _Boxes:
    """Pillow's ``BoxReader`` over ``data[pos:end]`` (``end`` None: no
    known length)."""

    def __init__(self, data: bytes, pos: int, end: Optional[int]):
        self.d, self.pos, self.end = data, pos, end
        self.remaining = -1

    def _can_read(self, n: int) -> bool:
        if self.end is not None and self.pos + n > self.end:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read(self, n: int) -> bytes:
        if not self._can_read(n):
            raise SyntaxError("Not enough data in header")
        out = self.d[self.pos:self.pos + n]
        if len(out) < n:
            raise OSError(f"Expected to read {n} bytes but only got "
                          f"{len(out)}.")
        self.pos += n
        if self.remaining > 0:
            self.remaining -= n
        return out

    def fields(self, fmt: str):
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))

    def sub(self) -> "_Boxes":
        n = self.remaining
        start = self.pos
        self.read(n)
        return _Boxes(self.d[start:start + n], 0, n)

    def has_next(self) -> bool:
        return self.end is None or self.pos + self.remaining < self.end

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise SyntaxError("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _getcolor(pal: bytearray, colors: dict, mode: str, color: tuple) -> None:
    """``ImagePalette.getcolor`` of a palette built from nothing."""
    if mode == "RGB" and len(color) == 4:
        if color[3] != 255:
            raise ValueError("cannot add non-opaque RGBA color to RGB palette")
        color = color[:3]
    elif mode == "RGBA" and len(color) == 3:
        color += (255,)
    if color in colors:
        return
    n = len(mode)
    index = len(pal) // n
    if index >= 256:
        raise ValueError("cannot allocate more than 256 colors")
    colors[color] = index
    if index * n < len(pal):
        pal[index * n:index * n + n] = bytes(color)
    else:
        pal += bytes(color)


def _jp2_header(data: bytes) -> dict:
    """``_parse_jp2_header`` after the 12-byte signature box."""
    reader = _Boxes(data, 12, None)
    header = None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.sub()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    if header is None:
        raise AssertionError("no jp2h box")
    size = mode = nc = None
    palette = None
    pmode = "RGB"
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            else:
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                pmode = "RGBA" if npc == 4 else "RGB"
                pal, colors = bytearray(), {}
                for _ in range(ne):
                    _getcolor(pal, colors, pmode,
                              header.fields(">" + "B" * npc))
                palette = bytes(pal)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    return dict(size=size, mode=mode, palette=palette, palette_mode=pmode)


def _codestream_mode(data: bytes, pos: int):
    """``_parse_codestream`` at the SIZ segment's length field."""
    lsiz = struct.unpack_from(">H", data, pos)[0]
    siz = data[pos:pos + lsiz]
    fields = struct.unpack_from(">HHIIIIIIIIH", siz)
    xsiz, ysiz, xo, yo, csiz = fields[2], fields[3], fields[4], fields[5], \
        fields[10]
    size = (xsiz - xo, ysiz - yo)
    if csiz == 1:
        mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1 > 8 \
            else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise SyntaxError("unable to determine J2K image mode")
    return size, mode


def _comment_walk(data: bytes, pos: int) -> None:
    """``_parse_comment``: its faults (a short marker or length) raise as
    Pillow's do."""
    while True:
        marker = data[pos:pos + 2]
        pos += 2
        if not marker:
            return
        typ = marker[1]
        if typ in (0x90, 0xD9):
            return
        length = struct.unpack_from(">H", data[pos:pos + 2])[0]
        pos += 2
        if typ == 0x64:
            return
        pos += length - 2


def open_jpeg2000(data: bytes, path: str = "image") -> dict:
    """``Jpeg2KImageFile._open``: the header, or an error where
    ``Image.open`` moves on (``SyntaxError``, ``struct.error``) or raises."""
    if data[:4] == _SOC_SIZ:
        size, mode = _codestream_mode(data, 4)
        _comment_walk(data, 4 + struct.unpack_from(">H", data, 4)[0])
        return dict(size=size, mode=mode, codec="j2k", palette=None,
                    palette_mode="RGB")
    if data[:12] != _JP2:
        raise SyntaxError("not a JPEG 2000 file")
    head = _jp2_header(data)
    head["codec"] = "jp2"
    return head


# ------------------------------------------------------------------ load
def _codestream(data: bytes, head: dict) -> tuple:
    """The codestream and OpenJPEG's colour space: for a JP2 file, the
    ``jp2c`` box that follows ``jp2h`` (OpenJPEG's own box walk), and the
    space of its first ``colr``."""
    if head["codec"] == "j2k":
        return data, _UNSPECIFIED
    pos, n, space, colr_seen = 0, len(data), None, False
    while pos + 8 <= n:
        lbox, tbox = struct.unpack(">I4s", data[pos:pos + 8])
        hlen = 8
        if lbox == 1:
            if pos + 16 > n:
                break
            lbox, hlen = struct.unpack(">Q", data[pos + 8:pos + 16])[0], 16
            if lbox >> 32:
                raise ValueError("a box of more than 2^32 bytes")
        elif lbox == 0:
            lbox = n - pos
        if lbox < hlen or pos + lbox > n:
            raise ValueError(f"box {tbox!r} runs past the file")
        body = data[pos + hlen:pos + lbox]
        if tbox == b"jp2h":
            space = _UNSPECIFIED
            sub = 0
            while sub + 8 <= len(body):
                sl, st = struct.unpack(">I4s", body[sub:sub + 8])
                if sl < 8 or sub + sl > len(body):
                    raise ValueError("a broken box in jp2h")
                if st == b"colr" and not colr_seen:
                    colr_seen = True
                    meth = body[sub + 8]
                    if meth == 1 and sl >= 15:
                        enumcs = struct.unpack(">I", body[sub + 11:sub + 15])[0]
                        space = _ENUMCS.get(enumcs, _UNSPECIFIED)
                sub += sl
        elif tbox == b"jp2c":
            if space is None:
                raise ValueError("jp2c before jp2h")
            return body, space
        pos += lbox
    raise ValueError("no codestream (jp2c) box")


def _native():
    """The C++ stages, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SOURCE, EXTRA_FLAGS)))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.j2k_tier2.restype = ctypes.c_int
            lib.j2k_tier2.argtypes = [ctypes.c_char_p, i64, i32, i32, vp, vp,
                                      i32, vp, i32, vp, vp, vp, vp, vp, vp,
                                      ctypes.c_char_p, i32]
            lib.j2k_tier1.restype = ctypes.c_int
            lib.j2k_tier1.argtypes = [ctypes.c_char_p, i32, vp, vp, vp, vp,
                                      vp, vp, vp, vp, ctypes.c_char_p, i32]
            lib.j2k_idwt.restype = ctypes.c_int
            lib.j2k_idwt.argtypes = [vp, i32, i32, i32, vp, i32, vp, vp, i32,
                                     vp]
            lib.j2k_mct.restype = ctypes.c_int
            lib.j2k_mct.argtypes = [i32, i64, vp, i32, vp]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _err(rc: int, err) -> None:
    if rc != 0:
        raise cs.Corrupt(err.value.decode(errors="replace"))


def tier2(data: bytes, lay: cs.Layout, sop: bool, plain: bool = False):
    """Tier-2 of one tile: see ``j2k_plain.tier2``."""
    mb = np.ascontiguousarray(lay.cblk[:, 6], np.int32)
    if plain:
        return j2k_plain.tier2(data, lay.pk, lay.pb_list, lay.pb, mb, sop)
    n = len(mb)
    numbps = np.zeros(n, np.int32)
    passes = np.zeros(n, np.int32)
    offsets = np.zeros(n, np.int64)
    lengths = np.zeros(n, np.int32)
    out = np.zeros(len(data) + 1, np.uint8)
    pk = np.ascontiguousarray(lay.pk, np.int32)
    pbl = np.ascontiguousarray(lay.pb_list, np.int32)
    pb = np.ascontiguousarray(lay.pb, np.int32)
    err = ctypes.create_string_buffer(256)
    rc = _native().j2k_tier2(data, len(data), int(sop), len(pk), _ptr(pk),
                             _ptr(pbl), len(pb), _ptr(pb), n, _ptr(mb),
                             _ptr(numbps), _ptr(passes), _ptr(offsets),
                             _ptr(lengths), _ptr(out), err, 256)
    _err(rc, err)
    return numbps, passes, offsets, lengths, out.tobytes()


def tier1(blob: bytes, lay: cs.Layout, numbps, passes, offsets, lengths,
          planes: list, plain: bool = False) -> None:
    """Tier-1 of every code-block of one tile into its component's
    coefficient plane (int32, ``planes[c]``)."""
    cb = lay.cblk
    if plain:
        for k in range(len(cb)):
            c, px, py, w, h, orient, _ = (int(v) for v in cb[k])
            if passes[k] == 0:
                continue
            seg = blob[int(offsets[k]):int(offsets[k]) + int(lengths[k])]
            planes[c][py:py + h, px:px + w] = j2k_plain.tier1(
                seg, w, h, orient, int(numbps[k]), int(passes[k]))
        return
    n = len(cb)
    comp = np.ascontiguousarray(cb[:, 0], np.int32)
    geo = np.ascontiguousarray(cb[:, 1:6], np.int32)  # px, py, w, h, orient
    base = np.array([p.ctypes.data for p in planes], np.uint64)
    strides = np.array([p.shape[1] for p in planes], np.int32)
    err = ctypes.create_string_buffer(256)
    rc = _native().j2k_tier1(blob, n, _ptr(comp), _ptr(geo),
                             _ptr(np.ascontiguousarray(numbps, np.int32)),
                             _ptr(np.ascontiguousarray(passes, np.int32)),
                             _ptr(np.ascontiguousarray(offsets, np.int64)),
                             _ptr(np.ascontiguousarray(lengths, np.int32)),
                             _ptr(base), _ptr(strides), err, 256)
    _err(rc, err)


def band_steps(lay: cs.Layout, c: int, prec: int, reversible: bool) -> list:
    """Each band's plane rectangle and dequantisation step (half of
    OpenJPEG's ``band->stepsize``, a float32)."""
    out = []
    for ox, oy, ox1, oy1, orient, mb, e, m, r in lay.bands[c]:
        if reversible:
            step = 1.0
        else:
            full = np.float32((1.0 + m / 2048.0) * 2.0 ** (prec - e))
            step = float(np.float32(0.5) * full)
        out.append((ox, oy, ox1, oy1, step))
    return out


def idwt(coef: np.ndarray, res: np.ndarray, bands: list, reversible: bool,
         plain: bool = False) -> np.ndarray:
    """Dequantisation and the inverse DWT of one tile-component."""
    if plain:
        return j2k_plain.idwt(coef, res, bands, reversible)
    h, w = coef.shape
    out = coef.copy() if reversible else np.zeros((h, w), np.float32)
    rr = np.ascontiguousarray(res, np.int32)
    rect = np.array([b[:4] for b in bands], np.int32).reshape(-1, 4)
    step = np.array([b[4] for b in bands], np.float32)
    rc = _native().j2k_idwt(_ptr(out), w, h, len(rr), _ptr(rr),
                            int(reversible), _ptr(rect), _ptr(step),
                            len(bands), _ptr(coef))
    if rc != 0:
        raise cs.Corrupt("inverse DWT")
    return out


def mct(planes: list, mct_on: bool, prec: list, sgnd: list,
        plain: bool = False) -> list:
    """The inverse MCT, DC shift and clamp of one tile."""
    if plain:
        return j2k_plain.mct(planes, mct_on, prec, sgnd)
    n = planes[0].size
    src = [np.ascontiguousarray(p) for p in planes]
    out = [np.empty(p.shape, np.int32) for p in planes]
    ptrs = np.array([p.ctypes.data for p in src] +
                    [p.ctypes.data for p in out], np.uint64)
    kinds = np.array([p.dtype == np.float32 for p in src] + list(prec)
                     + list(sgnd), np.int32)
    if any(p.size != n for p in src):
        raise cs.Corrupt("components of different sizes")
    _native().j2k_mct(len(src), n, _ptr(ptrs), int(bool(mct_on)),
                      _ptr(kinds))
    return out


def decode_tile(hdr: cs.Header, tile: cs.Tile, plain: bool = False,
                seconds: Optional[dict] = None,
                keep: Optional[list] = None) -> list:
    """One tile's components: int32 samples after the DC shift and clamp.
    ``keep``, where given, receives every stage's output: (tier-2's five,
    tier-1's planes, the inverse DWT's samples, the components)."""
    import time

    t = time.perf_counter()

    def lap(key):
        nonlocal t
        if seconds is not None:
            now = time.perf_counter()
            seconds[key] = seconds.get(key, 0.0) + now - t
            t = now

    p = tile.params
    if p.eph:
        raise cs.Unsupported("EPH markers")
    lay = cs.layout(hdr, tile)
    lap("layout")
    data = b"".join(tile.parts)
    numbps, passes, offsets, lengths, blob = tier2(data, lay, p.sop, plain)
    lap("tier2")
    planes = []
    for c in range(hdr.ncomp):
        x0, y0, x1, y1 = lay.rect[c]
        planes.append(np.zeros((y1 - y0, x1 - x0), np.int32))
    tier1(blob, lay, numbps, passes, offsets, lengths, planes, plain)
    lap("tier1")
    samples = []
    for c in range(hdr.ncomp):
        rev = bool(p.coding[c].reversible)
        samples.append(idwt(planes[c], lay.res[c],
                            band_steps(lay, c, hdr.prec[c], rev), rev, plain))
    lap("idwt")
    mct_on = p.mct == 1 and hdr.ncomp >= 3
    if mct_on and any(s.dtype != samples[0].dtype for s in samples[:3]):
        raise cs.Unsupported("a colour transform over mixed wavelets")
    out = mct(samples, mct_on, hdr.prec, hdr.sgnd, plain)
    lap("mct")
    if keep is not None:
        keep.append(((numbps, passes, offsets, lengths, blob), planes,
                     samples, out))
    return out


def decode_codestream(code: bytes, plain: bool = False,
                      seconds: Optional[dict] = None,
                      keep: Optional[list] = None):
    """``(header, [(tile rectangle, components)])`` of every tile."""
    hdr = cs.parse(code)
    return hdr, [(cs.tile_rect(hdr, index),
                  decode_tile(hdr, hdr.tiles[index], plain, seconds, keep))
                 for index in sorted(hdr.tiles)]


def same_stages(a: list, b: list) -> bool:
    """Whether two ``keep`` lists hold the same values, float32 samples
    bit for bit (the joined bytes compared as far as the blocks use)."""
    if len(a) != len(b):
        return False
    for (ta, pa, sa, ca), (tb, pb, sb, cb) in zip(a, b):
        used = int(ta[2][-1] + ta[3][-1]) if len(ta[2]) else 0
        if ta[4][:used] != tb[4][:used] or not all(
                np.array_equal(x, y) for x, y in zip(ta[:4], tb[:4])):
            return False
        for x, y in zip(pa + sa + ca, pb + sb + cb):
            if x.dtype != y.dtype or not np.array_equal(
                    x.view(np.int32), y.view(np.int32)):
                return False
    return True


# ------------------------------------------------------------------ unpack
def _shifted(v: np.ndarray, prec: int, sgnd: int, bits: int) -> np.ndarray:
    """``j2ku_shift(offset + word, shift)`` in unsigned 32-bit C, where
    ``word`` is the sample in OpenJPEG's 1, 2 or 4 bytes."""
    csiz = (prec + 7) >> 3
    csiz = 4 if csiz == 3 else csiz
    word = v.astype(np.int64) & ((1 << (8 * csiz)) - 1)
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = (word + offset) & 0xFFFFFFFF
    x = x >> -shift if shift < 0 else (x << shift) & 0xFFFFFFFF
    return x


# ``ConvertYCbCr.c``'s tables (scaled by 2^6), which follow no one
# rounding of 1.402, 0.34414, 0.71414 and 1.772: each is the truncated
# product plus the corrections below, found against Pillow 12.1 over every
# (Cb, Cr) pair (``tests/test_torch_port_images_jpeg2000.py`` holds all
# 65,536).  R_Cr and B_Cb enter only shifted; G_Cb and G_Cr as a sum.
_R_FIX, _B_FIX = {118: 1, 225: 1}, {93: 1}
_G_CB_LESS = ("0100101000000000000000000000101101010010100101000000000000000000"
    "0000001010010101101010010000000000000000000001010010101101011010"
    "1000000000000000000000110101101010010100100000000000000000000010"
    "1001010010101101000000000000000000000101001010010101101010000000")
_G_CR_MORE = ("0221121022112102212210211221021122122112112212211221221121122122"
    "1121122112112212211211221121122122112112212211221221121122122112"
    "1122112112212211211221121122122112112212211221221121122122112212"
    "2112112212211211221121122122112112212211221221121122122112212211")


def _ycc_tables():
    """R_Cr >> 6, G_Cb, G_Cr and B_Cb >> 6."""
    i = np.arange(256, dtype=np.float64) - 128
    r = np.trunc(1.402 * 64 * i).astype(np.int64) >> 6
    b = np.trunc(1.772 * 64 * i).astype(np.int64) >> 6
    for k, v in _R_FIX.items():
        r[k] += v
    for k, v in _B_FIX.items():
        b[k] += v
    g_cb = np.trunc(-0.34414 * 64 * i).astype(np.int64) - np.array(
        [int(c) for c in _G_CB_LESS])
    g_cr = np.trunc(-0.71414 * 64 * i).astype(np.int64) + np.array(
        [int(c) for c in _G_CR_MORE])
    return r, g_cb, g_cr, b


def ycc_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """``ImagingConvertYCbCr2RGB`` on (..., 3) uint8."""
    r_cr, g_cb, g_cr, b_cb = _ycc_tables()
    y = ycc[..., 0].astype(np.int64)
    cb, cr = ycc[..., 1], ycc[..., 2]
    r = y + r_cr[cr]
    g = y + ((g_cb[cb] + g_cr[cr]) >> 6)
    b = y + b_cb[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _unpack(kind: str, comps: list, prec: list, sgnd: list, mode: str):
    def u8(i):
        return (_shifted(comps[i], prec[i], sgnd[i], 8) & 0xFF).astype(np.uint8)

    if kind == "i16":
        return (_shifted(comps[0], prec[0], sgnd[0], 16) & 0xFFFF).astype(
            np.uint16)
    if kind == "gray":
        return u8(0)
    if kind == "gray_rgb":
        g = u8(0)
        out = [g, g, g]
    elif kind == "la":
        g = u8(0)
        out = [g, g, g, u8(1)]
    elif kind in ("rgb", "ycc"):
        out = [u8(0), u8(1), u8(2)]
    else:  # rgba, ycca
        out = [u8(0), u8(1), u8(2), u8(3)]
    px = np.stack(out, -1)
    if kind in ("ycc", "ycca"):
        px[..., :3] = ycc_to_rgb(px[..., :3])
    if mode in ("L", "P"):
        return px[..., 0]
    if mode in ("LA", "PA"):
        return px[..., [0, 3]]
    if mode == "RGB":
        return px[..., :3]
    if px.shape[-1] == 3:
        return np.concatenate([px, np.full(px.shape[:2] + (1,), 255,
                                           np.uint8)], -1)
    return px


def load_jpeg2000(data: bytes, head: dict, seconds: Optional[dict] = None):
    """``(pixels, mode, palette, transparency)`` of an opened header."""
    code, space = _codestream(data, head)
    try:
        px = _decode_into(code, space, head, seconds)
    except (struct.error, IndexError) as e:
        raise cs.Corrupt(f"a broken marker segment ({e})") from None
    palette = transparency = None
    if head["palette"] is not None:
        pal = np.frombuffer(head["palette"], np.uint8)
        k = len(head["palette_mode"])
        pal = pal[:len(pal) // k * k].reshape(-1, k)
        palette = np.ascontiguousarray(pal[:, :3])
        if k == 4:
            transparency = pal[:, 3].tobytes()
    return px, head["mode"], palette, transparency


def _decode_into(code: bytes, space: int, head: dict,
                 seconds: Optional[dict]) -> np.ndarray:
    """``Jpeg2KDecode.c``'s checks on the header, then each tile's
    rectangle, then its decode unpacked into the opened size."""
    hdr = cs.parse(code)
    mode = head["mode"]
    n = hdr.ncomp
    if n < 1 or n > 4:
        raise ValueError(f"broken data stream: {n} components")
    if space == _UNSPECIFIED:
        space = _GRAY if n <= 2 else _SRGB
    kind = _UNPACKERS.get((mode, space, n))
    if kind is None:
        raise ValueError(f"broken data stream: no unpacker of {n} "
                         f"components in colour space {space} to {mode}")
    w, h = head["size"]
    shape = (h, w) if mode in ("L", "P", "I;16", "I;16B") else \
        (h, w, {"LA": 2, "PA": 2, "RGB": 3}.get(mode, 4))
    px = np.zeros(shape, np.uint16 if mode.startswith("I;16") else np.uint8)
    for index in sorted(hdr.tiles):
        tx0, ty0, tx1, ty1 = cs.tile_rect(hdr, index)
        if tx0 >= tx1 or ty0 >= ty1 or tx0 < hdr.xo or ty0 < hdr.yo or \
                tx1 - hdr.xo > w or ty1 - hdr.yo > h:
            raise ValueError("broken data stream: a tile outside the image")
        comps = decode_tile(hdr, hdr.tiles[index], seconds=seconds)
        px[ty0 - hdr.yo:ty1 - hdr.yo, tx0 - hdr.xo:tx1 - hdr.xo] = _unpack(
            kind, comps, hdr.prec, hdr.sgnd, mode)
    return px
