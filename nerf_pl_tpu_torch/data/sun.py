"""A Sun raster reader: what Pillow's ``SunImagePlugin`` gives.

The 32-byte big-endian header: depth 1 (``1``, rawmode ``1;I``: 0 is
white), 4 (``L;4``), 8 (``L``), 24 and 32 (``RGB`` from ``BGR`` and
``BGRX``, or ``RGB`` and ``RGBX`` for type 3); a colour map (type 1, at
most 1024 bytes, three planes) makes ``L`` into ``P`` (rawmode ``P;4`` or
``P``) with that palette; on the other modes Pillow's load refuses it.
Types 0, 1, 3, 4 and 5 are raw rows padded to 16 bits; type 2 is the
``sun_rle`` stream (rows not padded) of ``rle_plain``, which runs in C++
(``data/rle.py``).
"""
from __future__ import annotations

import struct

import numpy as np

from . import rle, unpack


def open_sun(data: bytes) -> dict:
    s = data[:32]
    if len(s) < 4 or struct.unpack(">I", s[:4])[0] != 0x59A66A95:
        raise SyntaxError("not an SUN raster file")
    w, h, depth, _, ftype, ptype, plen = struct.unpack(">7I", s[4:32])
    if depth == 1:
        mode, rawmode = "1", "1;I"
    elif depth == 4:
        mode, rawmode = "L", "L;4"
    elif depth == 8:
        mode = rawmode = "L"
    elif depth in (24, 32):
        mode = "RGB"
        rawmode = ("RGB" if ftype == 3 else "BGR") + ("X" if depth == 32
                                                      else "")
    else:
        raise SyntaxError("Unsupported Mode/Bit Depth")
    offset, palette = 32, None
    if plen:
        if plen > 1024:
            raise SyntaxError("Unsupported Color Palette Length")
        if ptype != 1:
            raise SyntaxError("Unsupported Palette Type")
        raw = data[32:32 + plen]
        n = len(raw) // 3
        palette = np.frombuffer(raw, np.uint8, 3 * n).reshape(3, n).T.copy()
        offset += plen
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise SyntaxError("Unsupported Sun Raster file type")
    return dict(size=(w, h), mode=mode, rawmode=rawmode, palette=palette,
                offset=offset, rle=ftype == 2,
                stride=((w * depth + 15) // 16) * 2)


def rle_plain(data: bytes, row_bytes: int, h: int) -> np.ndarray:
    """Pillow's ``SunRleDecode``: (h, row_bytes) bytes."""
    total = row_bytes * h
    out = bytearray(total)
    pos = o = 0
    n = len(data)
    while o < total:
        if pos >= n:
            raise ValueError(rle.ERRORS[-1])
        c = data[pos]
        if c == 0x80:
            if pos + 2 > n:
                raise ValueError(rle.ERRORS[-1])
            if data[pos + 1] == 0:
                out[o] = 0x80
                o, pos = o + 1, pos + 2
            else:
                if pos + 3 > n:
                    raise ValueError(rle.ERRORS[-1])
                k = min(data[pos + 1] + 1, total - o)
                out[o:o + k] = bytes([data[pos + 2]]) * k
                o, pos = o + k, pos + 3
        else:
            out[o] = c
            o, pos = o + 1, pos + 1
    return np.frombuffer(bytes(out), np.uint8).reshape(h, row_bytes)


def load_sun(data: bytes, head: dict, plain: bool = False):
    (w, h), mode, rawmode = head["size"], head["mode"], head["rawmode"]
    if head["palette"] is not None and mode != "P":
        raise ValueError(f"a colour map on a {mode} image (Pillow's "
                         "putpalette refuses it)")
    if head["rle"]:
        rows = (rle_plain if plain else rle.sun_rle)(
            data[head["offset"]:], unpack.row_bytes(w, rawmode), h)
        px = unpack.unpack(mode, rawmode, rows, w)
    else:
        px = unpack.raw(data, head["offset"], (w, h), mode, rawmode,
                        stride=head["stride"])
    return px, mode, head["palette"], None
