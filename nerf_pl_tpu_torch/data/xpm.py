"""An X11 pixmap reader: what Pillow's ``XpmImagePlugin`` gives.

After ``/* XPM */``, the first line that starts ``"w h colours cpp``, then
one line a colour (``c #rrggbb``; ``c None`` is the transparency, kept as
its key's bytes as Pillow keeps it; any other colour or no ``c`` key
raises), then the pixel lines (``/* pixels */`` skipped once; each line's
text between its first and last double quote, ``cpp`` bytes a pixel).  Up
to 256 colours the picture is ``P`` with the colours in their order (a
key not among them raises, as ``tuple.index``); past that, ``RGB``.
"""
from __future__ import annotations

import io
import re

import numpy as np

from . import unpack

_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def open_xpm(data: bytes) -> dict:
    fp = io.BytesIO(data)
    if fp.read(9) != b"/* XPM */":
        raise SyntaxError("not an XPM file")
    while True:
        line = fp.readline()
        if not line:
            raise SyntaxError("broken XPM file")
        m = _HEAD.match(line)
        if m:
            break
    size = int(m.group(1)), int(m.group(2))
    ncolours, bpp = int(m.group(3)), int(m.group(4))
    palette, transparency = {}, None
    for _ in range(ncolours):
        line = fp.readline().rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1]
                if rgb == b"None":
                    transparency = c
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[c] = bytes(((v >> 16) & 255, (v >> 8) & 255,
                                        v & 255))
                else:
                    raise ValueError("cannot read this XPM file")
                break
        else:
            raise ValueError("cannot read this XPM file")
    return dict(size=size, mode="RGB" if ncolours > 256 else "P", bpp=bpp,
                colours=palette, transparency=transparency, offset=fp.tell())


def load_xpm(data: bytes, head: dict):
    (w, h), mode, bpp = head["size"], head["mode"], head["bpp"]
    colours = head["colours"]
    index = {k: i for i, k in enumerate(colours)}
    fp = io.BytesIO(data)
    fp.seek(head["offset"])
    need = w * h * (3 if mode == "RGB" else 1)
    out = bytearray()
    pixel_header = False
    while len(out) < need:
        line = fp.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not pixel_header:
            pixel_header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(line), bpp):
            key = line[i:i + bpp]
            if mode == "RGB":
                if key not in colours:
                    raise ValueError(f"an XPM pixel of key {key!r} not in "
                                     "its colours")
                out += colours[key]
            else:
                if key not in index:
                    raise ValueError("tuple.index(x): x not in tuple")
                out.append(index[key])
    px = unpack.set_as_raw(bytes(out), (w, h), mode, mode)
    if mode == "RGB":
        return px, mode, None, head["transparency"]
    palette = np.frombuffer(b"".join(colours.values()), np.uint8).reshape(
        -1, 3)
    return px, mode, palette.copy(), head["transparency"]
