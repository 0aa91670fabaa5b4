"""A QOI reader: what Pillow's ``QoiImagePlugin`` gives.

The 14-byte header (width and height big-endian, then the channels: 3 is
``RGB``, any other value ``RGBA``; the colour space is not read), then the
op stream from (0, 0, 0, 255): QOI_OP_INDEX (an empty slot of the 64-entry
index reads as 0, 0, 0, 0), QOI_OP_DIFF, QOI_OP_LUMA, QOI_OP_RUN (which
does not enter the index), QOI_OP_RGB and QOI_OP_RGBA, each decoded pixel
entering the index at its own hash ``(3r + 5g + 7b + 11a) % 64``.  A stream
that ends first raises ``ValueError``.

The op stream runs in C++ (``data/rle.py``); ``ops_plain`` is the same
stage in Python.
"""
from __future__ import annotations

import struct

import numpy as np

from . import rle


def open_qoi(data: bytes) -> dict:
    """``QoiImageFile._open``: the header, or ``struct.error``/IndexError
    where ``Image.open`` moves on."""
    w, h = struct.unpack(">II", data[4:12])
    channels = data[12]
    return dict(size=(w, h), mode="RGB" if channels == 3 else "RGBA")


def ops_plain(data: bytes, npix: int) -> np.ndarray:
    """Pillow's ``QoiDecoder``: (npix, 4) RGBA."""
    index = {}
    prev = (0, 0, 0, 255)
    out = bytearray()
    pos, n = 0, len(data)

    def take(k):
        nonlocal pos
        if pos + k > n:
            raise ValueError(rle.ERRORS[-1])
        pos += k
        return data[pos - k:pos]

    while len(out) < 4 * npix:
        b = take(1)[0]
        if b == 0xFE:
            v = tuple(take(3)) + prev[3:]
        elif b == 0xFF:
            v = tuple(take(4))
        elif b >> 6 == 0:
            v = index.get(b & 63, (0, 0, 0, 0))
        elif b >> 6 == 1:
            v = ((prev[0] + ((b >> 4) & 3) - 2) % 256,
                 (prev[1] + ((b >> 2) & 3) - 2) % 256,
                 (prev[2] + (b & 3) - 2) % 256, prev[3])
        elif b >> 6 == 2:
            b2 = take(1)[0]
            dg = (b & 63) - 32
            v = ((prev[0] + dg + (b2 >> 4) - 8) % 256, (prev[1] + dg) % 256,
                 (prev[2] + dg + (b2 & 15) - 8) % 256, prev[3])
        else:
            out += bytes(prev) * ((b & 63) + 1)
            continue
        index[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64] = v
        prev = v
        out += bytes(v)
    return np.frombuffer(bytes(out[:4 * npix]), np.uint8).reshape(npix, 4)


def load_qoi(data: bytes, head: dict, plain: bool = False):
    """``(pixels, mode, palette, transparency)`` of an opened header."""
    (w, h), mode = head["size"], head["mode"]
    px = (ops_plain if plain else rle.qoi)(data[14:], w * h).reshape(h, w, 4)
    if mode == "RGB":
        px = px[..., :3]
    return np.ascontiguousarray(px), mode, None, None
