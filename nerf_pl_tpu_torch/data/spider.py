"""A SPIDER reader: what Pillow's ``SpiderImagePlugin`` gives.

A header of 32-bit floats, big-endian where those hold a SPIDER header
(``is_header``: the integer fields integers, an ``iform`` Pillow knows,
the header's bytes its records times their length), else little-endian;
a 2D image (``iform`` 1) of ``F`` pixels (``F;32BF`` or ``F;32F``) after
the header, or, in a stack, after the stack's header and the first
image's.  The first image of a stack is frame 0.
"""
from __future__ import annotations

import struct

from . import unpack


def is_header(t) -> int:
    """``isSpiderHeader``: the header's bytes, or 0."""
    h = (99,) + tuple(t)
    for i in (1, 2, 5, 12, 13, 22, 23):
        try:
            if h[i] - int(h[i]) != 0:
                return 0
        except (ValueError, OverflowError):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    return int(h[22]) if int(h[22]) == int(h[13]) * int(h[23]) else 0


def open_spider(data: bytes) -> dict:
    """``SpiderImageFile._open``: the header, or ``SyntaxError`` where
    ``Image.open`` moves on."""
    try:
        big, t = True, struct.unpack(">27f", data[:108])
        hdrlen = is_header(t)
        if not hdrlen:
            big, t = False, struct.unpack("<27f", data[:108])
            hdrlen = is_header(t)
        if not hdrlen:
            raise SyntaxError("not a valid Spider file")
    except struct.error:
        raise SyntaxError("not a valid Spider file") from None
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    size = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        # Pillow reads self.stkoffset, which a first open has not set
        raise ValueError("an image within a stack opened on its own")
    else:
        raise SyntaxError("inconsistent stack header values")
    return dict(size=size, mode="F", offset=offset,
                rawmode="F;32BF" if big else "F;32F")


def load_spider(data: bytes, head: dict):
    px = unpack.raw(data, head["offset"], head["size"], "F", head["rawmode"])
    return px, "F", None, None
