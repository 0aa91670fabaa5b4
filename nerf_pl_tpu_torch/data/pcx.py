"""A PCX reader: what Pillow's ``PcxImagePlugin`` gives.

The layouts the plugin maps: 1-bit single-plane ``1``; 1-bit with 2 or 4
planes ``P`` through the header's 16-entry palette (bit planes ``P;2L`` and
``P;4L``, each plane read ``ceil(w / 8)`` bytes from the last, as Pillow's
unpacker does); 8-bit single-plane (version 5) ``L``, or ``P`` where the
file ends in a ``0x0C`` palette that is not the gray ramp; 8-bit
three-plane (version 5) ``RGB``.  Each row is ``planes * stride`` bytes of
runs, the stride ``ceil(w * bits / 8)`` made even where the header gives
another; where that spaces the planes wider than their own bytes, they are
first packed together, as Pillow's ``PcxDecode`` does.  What else the plugin refuses (2 or 4 bits, a
version below 5 at 8 bits) raises ``ValueError``.

The run-length stage runs in C++ (``data/rle.py``); ``rle_plain`` is the
same stage in Python.
"""
from __future__ import annotations

import struct

import numpy as np

from . import rle


def _accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def open_pcx(data: bytes) -> dict:
    """``PcxImageFile._open``: the header, or ``SyntaxError``
    (``struct.error``, ``IndexError``) where ``Image.open`` moves on."""
    s = data[:68]
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise SyntaxError("bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    provided = struct.unpack_from("<H", s, 66)[0]
    palette = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3).copy()
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12:
            pal = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not (pal == np.arange(256)[:, None]).all():
                mode = rawmode = "P"
                palette = pal.copy()
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise ValueError(f"unknown PCX mode (version {version}, {bits} bits, "
                         f"{planes} planes)")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    return dict(size=(w, h), mode=mode, rawmode=rawmode, palette=palette,
                row_bytes=planes * stride)


def rle_plain(data: bytes, row_bytes: int, h: int) -> np.ndarray:
    """Pillow's ``PcxDecode``: (h, row_bytes) bytes."""
    out = np.zeros((h, row_bytes), np.uint8)
    pos, x, y, overrun, n = 0, 0, 0, False, len(data)
    while y < h:
        if pos >= n:
            raise ValueError(rle.ERRORS[-1])
        c = data[pos]
        if c & 0xC0 == 0xC0:
            if pos + 2 > n:
                raise ValueError(rle.ERRORS[-1])
            k = c & 0x3F
            if x + k > row_bytes:
                overrun, k = True, row_bytes - x
            out[y, x:x + k] = data[pos + 1]
            x += k
            pos += 2
        else:
            out[y, x] = c
            x += 1
            pos += 1
        if x >= row_bytes:
            x, y = 0, y + 1
    if overrun:
        raise ValueError(rle.ERRORS[-2])
    return out


def _compact(rows: np.ndarray, w: int, rawbits: int) -> np.ndarray:
    """PcxDecode's packing of a row's planes before it unpacks them: for
    ``P;2L`` and ``P;4L`` (``rawbits`` 2, 4) each of the 2 or 4 bit planes
    of ``ceil(w / 8)`` bytes, else each of the ``row // w`` planes of ``w``
    bytes, moved next to the last where the row spaces them wider."""
    nbytes = rows.shape[1]
    if rawbits in (2, 4):
        size, bands = (w + 7) // 8, rawbits
    else:
        size, bands = w, nbytes // w
    stride = nbytes // bands if bands else 0
    if bands and stride > size:
        rows = rows.copy()
        for i in range(1, bands):
            rows[:, i * size:(i + 1) * size] = rows[:, i * stride:
                                                    i * stride + size]
    return rows


def _unpack(rawmode: str, rows: np.ndarray, w: int) -> np.ndarray:
    if rawmode == "1":
        return np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
    if rawmode in ("L", "P"):
        return rows[:, :w]
    if rawmode == "RGB;L":
        return np.stack([rows[:, k * w:(k + 1) * w] for k in range(3)], -1)
    planes = int(rawmode[2])
    s = (w + 7) // 8
    out = np.zeros((rows.shape[0], w), np.uint8)
    for k in range(planes):
        bits = np.unpackbits(rows[:, k * s:(k + 1) * s], axis=1)[:, :w]
        out |= bits << k
    return out


def load_pcx(data: bytes, head: dict, plain: bool = False):
    """``(pixels, mode, palette, transparency)`` of an opened header."""
    (w, h), rb = head["size"], head["row_bytes"]
    rows = (rle_plain if plain else rle.pcx_rle)(data[128:], rb, h)
    rawbits = {"1": 1, "P;2L": 2, "P;4L": 4, "RGB;L": 24}.get(
        head["rawmode"], 8)
    px = _unpack(head["rawmode"], _compact(rows, w, rawbits), w)
    return np.ascontiguousarray(px), head["mode"], head["palette"], None
