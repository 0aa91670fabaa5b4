"""An X11 bitmap reader: what Pillow's ``XbmImagePlugin`` gives: the
``#define`` width and height (and an optional hot spot) in the first 512
bytes up to the last ``_bits[]`` there, then ``1`` rows of ``ceil(w / 8)``
bytes, least significant bit first, each byte the two characters after an
``x`` (``XbmDecode``: any other character than a hex digit counts 0, and
the scan goes on three bytes past each ``x``)."""
from __future__ import annotations

import re

import numpy as np

from . import unpack

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]")
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789":
    _HEX[_c] = _c - ord("0")
for _c in b"abcdef":
    _HEX[_c] = _HEX[_c - 32] = _c - ord("a") + 10


def open_xbm(data: bytes) -> dict:
    m = _HEAD.match(data[:512])
    if not m:
        raise SyntaxError("not a XBM file")
    return dict(size=(int(m.group("width")), int(m.group("height"))),
                mode="1", offset=m.end())


def load_xbm(data: bytes, head: dict):
    (w, h), pos = head["size"], head["offset"]
    stride = (w + 7) // 8
    out = bytearray(h * stride)
    for k in range(len(out)):
        p = data.find(b"x", pos)
        if p < 0 or len(data) - p < 3:
            raise ValueError(unpack.TRUNCATED)
        out[k] = (_HEX[data[p + 1]] << 4) | _HEX[data[p + 2]]
        pos = p + 3
    rows = np.frombuffer(bytes(out), np.uint8).reshape(h, stride)
    return unpack.unpack("1", "1;R", rows, w), "1", None, None
