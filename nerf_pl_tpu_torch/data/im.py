"""IM and IMT readers: what Pillow's ``ImImagePlugin`` and
``ImtImagePlugin`` give.

IM: a text header of ``key: value`` lines (each under 101 bytes, at least
one of the plugin's keys) up to a 0 or 0x1A byte, then, past the next
0x1A, an optional 768-byte ``Lut`` (three planes) and the pixels, rows
bottom to top.  ``Image type`` names the mode and rawmode (``OPEN``; an
unknown type is kept as the mode, and refused at the load as Pillow's
core refuses it); a ``Lut`` that is not a gray ramp makes ``L`` and ``P``
into ``P`` (rawmode ``P``) and ``LA`` and ``PA`` into ``PA`` (``PA;L``)
with that palette; a gray one is dropped.  ``RGB3`` and ``RYB3`` images
are three planes read as the G, R and B bands in turn.  The bit-packed
``L*N image`` types (N other than 8, 16 and 32) go through Pillow's
``bit`` decoder (``unpack.bit_decode``).

IMT: ``key value`` lines (``width``, ``height``, ``pixel n8``), ``*``
comments, and the pixels (``L``, raw) after a 0x0C byte.
"""
from __future__ import annotations

import io
import re

import numpy as np

from . import unpack

COMMENT, FRAMES, LUT = "Comment", "File size (no of images)", "Lut"
SCALE, SIZE, MODE = "Scale (x,y)", "Image size (x*y)", "Image type"
TAGS = frozenset((COMMENT, "Date", "Digitalization equipment", FRAMES, LUT,
                  "Name", SCALE, SIZE, MODE))
OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
MODES = frozenset(("1", "L", "P", "PA", "LA", "RGB", "RGBA", "CMYK", "YCbCr",
                   "I", "F", "I;16", "I;16L", "I;16B"))


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def open_im(data: bytes) -> dict:
    """``ImImageFile._open``: the header, or ``SyntaxError`` (IndexError,
    TypeError) where ``Image.open`` moves on."""
    if b"\n" not in data[:100]:
        raise SyntaxError("not an IM file")
    fp = io.BytesIO(data)
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode, n = "L", 0
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        s = s + fp.readline()
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s.removesuffix(b"\n")
        m = _SPLIT.match(s)
        if not m:
            raise SyntaxError("syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            v = v[0] if len(v) == 1 else v
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        if k == COMMENT:
            info.setdefault(k, []).append(v)
        else:
            info[k] = v
        n += k in TAGS
    if not n:
        raise SyntaxError("not an IM file")
    size, mode = info[SIZE], info[MODE]
    if not isinstance(size, tuple):
        raise TypeError("an IM size of one number")
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise SyntaxError("IM file truncated")
    palette = None
    if LUT in info:
        lut = fp.read(768)
        gray = linear = True
        for i in range(256):
            if lut[i] == lut[i + 256] == lut[i + 512]:
                linear = linear and lut[i] == i
            else:
                gray = False
        if mode in ("L", "LA", "P", "PA") and not gray:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            palette = np.frombuffer(lut, np.uint8).reshape(3, 256).T.copy()
    return dict(size=size[:2], mode=mode, rawmode=rawmode, palette=palette,
                offset=fp.tell())


def load_im(data: bytes, head: dict):
    """``(pixels, mode, palette, transparency)`` of an opened header."""
    mode, rawmode, offs = head["mode"], head["rawmode"], head["offset"]
    w, h = head["size"]
    if not (isinstance(w, int) and isinstance(h, int)) or mode not in MODES:
        raise ValueError(f"an IM image of mode {mode!r} and size "
                         f"{head['size']}, which Pillow cannot make")
    if rawmode.startswith("F;") and rawmode[2:].isdigit() and int(
            rawmode[2:]) not in (8, 16, 32):
        px = unpack.bit_decode(data, offs, (w, h), int(rawmode[2:]))
        return px, mode, None, None
    if rawmode in ("RGB;T", "RYB;T"):
        bands = [unpack.raw(data, offs + k * w * h, (w, h), mode, band,
                            ystep=-1) for k, band in enumerate("GRB")]
        px = np.stack([bands[1], bands[0], bands[2]], -1)
    else:
        px = unpack.raw(data, offs, (w, h), mode, rawmode, ystep=-1)
    palette = head["palette"]
    if mode == "P" and palette is None:  # a new core image's: black
        palette = np.zeros((0, 3), np.uint8)
    return px, mode, palette, None


_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def open_imt(data: bytes) -> dict:
    """``ImtImageFile._open``, byte for byte."""
    fp = io.BytesIO(data)
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    w = h = 0
    size, mode, offset = (0, 0), "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":  # the pixels begin
            offset = fp.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = int(v)
            size = (w, h)
        elif k == b"height":
            h = int(v)
            size = (w, h)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    return dict(size=size, mode=mode, offset=offset)


def load_imt(data: bytes, head: dict):
    if head["offset"] is None:
        raise ValueError("cannot load this image (no 0x0C before the data)")
    return unpack.raw(data, head["offset"], head["size"], "L", "L"), "L", \
        None, None
