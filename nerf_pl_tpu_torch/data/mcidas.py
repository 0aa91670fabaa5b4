"""A McIdas area reader: what Pillow's ``McIdasImagePlugin`` gives.

The 256-byte area directory (64 big-endian words after the 8-byte magic):
bytes a pixel (word 11: 1 ``L``, 2 ``I;16B``, 4 ``I`` from ``I;32B``),
the size (words 10 and 9), the data offset (34) and line prefix (15) and
the bands (14) that make each row's stride; the pixels are raw rows.
"""
from __future__ import annotations

import struct

from . import unpack

_MODES = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}


def open_mcidas(data: bytes) -> dict:
    s = data[:256]
    if s[:8] != b"\0\0\0\0\0\0\0\4" or len(s) != 256:
        raise SyntaxError("not an McIdas area file")
    w = (0,) + struct.unpack("!64i", s)
    if w[11] not in _MODES:
        raise SyntaxError("unsupported McIdas format")
    mode, rawmode = _MODES[w[11]]
    return dict(size=(w[10], w[9]), mode=mode, rawmode=rawmode,
                offset=w[34] + w[15], stride=w[15] + w[10] * w[11] * w[14])


def load_mcidas(data: bytes, head: dict):
    if head["offset"] < 0:
        raise ValueError("Tile offset cannot be negative")
    px = unpack.raw(data, head["offset"], head["size"], head["mode"],
                    head["rawmode"], stride=head["stride"])
    return px, head["mode"], None, None
