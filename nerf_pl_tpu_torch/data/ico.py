"""ICO and CUR readers: what Pillow's ``IcoImagePlugin`` and
``CurImagePlugin`` give.

ICO: the directory's entries (a width or height of 0 is 256; the colour
depth is the entry's bit count, else ``ceil(log2(colours))``, else 256)
sorted as ``IcoFile`` sorts them, by colour depth ascending and then,
stably, by area descending; Pillow loads the first (the largest icon, at
its smallest depth).  A PNG payload is read by ``data/png.py`` in its own
mode and at its own size, its ``tRNS`` converting as the PNG's own (Pillow
takes the PNG's core image, palette alphas and all); a DIB payload by ``data/bmp.py``'s DIB path, half its
stored height, then as ``RGBA``: the AND mask (1 bit a pixel, rows padded
to 32 bits, ending where the directory's size ends) as the alpha below 32
bits, each pixel's fourth byte at 32 bits.

CUR: the cursor whose width and height both exceed every earlier pick's
(the first, else), a DIB at half its stored height without the AND mask;
32-bit pixels read ``BGRA`` only when the bitmap sits at offset 22 (a
single-cursor file), else ``BGRX``.  A directory of no cursors is not this
format, and ``Image.open`` moves on.
"""
from __future__ import annotations

import math
import struct

import numpy as np

from . import bmp, png

_PNG = b"\x89PNG\r\n\x1a\n"


def _entries(data: bytes):
    """``IcoFile``'s directory, sorted as it sorts it."""
    count = struct.unpack_from("<H", data, 4)[0]
    out = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        w, h, ncol = s[0] or 256, s[1] or 256, s[2]
        bpp = struct.unpack_from("<H", s, 6)[0]
        size, offset = struct.unpack_from("<II", s, 8)
        depth = bpp or (ncol != 0 and math.ceil(math.log(ncol, 2))) or 256
        out.append(dict(dim=(w, h), bpp=bpp, size=size, offset=offset,
                        depth=depth))
    out.sort(key=lambda e: e["depth"])
    out.sort(key=lambda e: e["dim"][0] * e["dim"][1], reverse=True)
    return out


def decode_ico(data: bytes, name: str = "ICO"):
    """``(pixels, mode, palette, transparency)`` of the entry Pillow loads.
    ``SyntaxError`` (``struct.error``, IndexError) where ``Image.open``
    moves on: the plugin decodes in its ``_open``."""
    entries = _entries(data)
    e = entries[0]
    at = e["offset"]
    if data[at:at + 8] == _PNG:
        return png.decode_png(data[at:], name)
    px, mode, palette, _, o = bmp.decode_dib(data, name, at, halve=True)
    h, w = px.shape[:2]
    if mode == "P":
        rgb = np.zeros((256, 3), np.uint8)
        rgb[:min(len(palette), 256)] = palette[:256]
        rgb = rgb[px]
    elif mode in ("1", "L"):
        rgb = np.repeat(px[..., None], 3, -1)
    else:
        rgb = px[..., :3]
    if e["bpp"] == 32:
        raw = data[o:o + w * h * 4][3::4]
        if len(raw) < w * h:
            raise ValueError(f"{name}: not enough image data for the alpha")
        alpha = np.frombuffer(raw, np.uint8).reshape(h, w)[::-1]
    else:
        wpad = w + (-w % 32)
        total = wpad * h // 8
        start = e["offset"] + e["size"] - total
        mask = data[start:start + total] if start >= 0 else b""
        if len(mask) < total:
            raise ValueError(f"{name}: not enough image data for the mask")
        bits = np.unpackbits(np.frombuffer(mask, np.uint8).reshape(
            h, wpad // 8), axis=1)[:, :w]
        alpha = np.where(bits, 0, 255).astype(np.uint8)[::-1]
    rgba = np.concatenate([rgb, alpha[..., None]], -1)
    return np.ascontiguousarray(rgba), "RGBA", None, None


def decode_cur(data: bytes, name: str = "CUR"):
    """``(pixels, mode, palette, transparency)`` of the cursor Pillow
    picks; ``SyntaxError``/``TypeError`` where ``Image.open`` moves on."""
    count = struct.unpack_from("<H", data, 4)[0]
    pick = b""
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if not pick:
            pick = s
        elif s[0] > pick[0] and s[1] > pick[1]:
            pick = s
    if not pick:
        raise TypeError("No cursors were found")
    at = struct.unpack_from("<I", pick, 12)[0]
    return bmp.decode_dib(data, name, at, halve=True, raw_alpha=at == 22)[:4]
