"""An XV thumbnail reader: what Pillow's ``XVThumbImagePlugin`` gives: the
``P7 332`` line, ``#`` comment lines, a line of the width and height,
then ``P`` bytes in the fixed 3-3-2 palette."""
from __future__ import annotations

import io

import numpy as np

from . import unpack

PALETTE = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                    for r in range(8) for g in range(8) for b in range(4)],
                   np.uint8)


def open_xvthumb(data: bytes) -> dict:
    fp = io.BytesIO(data)
    if fp.read(6) != b"P7 332":
        raise SyntaxError("not an XV thumbnail file")
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise SyntaxError("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    w, h = s.strip().split(maxsplit=2)[:2]
    return dict(size=(int(w), int(h)), mode="P", offset=fp.tell())


def load_xvthumb(data: bytes, head: dict):
    px = unpack.raw(data, head["offset"], head["size"], "P", "P")
    return px, "P", PALETTE, None
