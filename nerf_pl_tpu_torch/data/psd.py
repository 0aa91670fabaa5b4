"""A PSD reader: the composite image, as Pillow's ``PsdImagePlugin`` gives
it (the layers are Pillow's frames 1..n, and are not read).

``(colour mode, depth)`` as the plugin's ``MODES``: bitmap ``1``, gray,
duotone and multichannel ``L``, indexed ``P`` (the 768-byte colour-mode data
as a planar palette; any other size leaves the palette empty), ``RGB``
(``RGBA`` at exactly 4 channels; past 4 the extra ones are dropped),
``CMYK`` (stored inverted: the ``;I`` raw modes) and ``LAB`` (its a and
b stored signed, read with 128 added).  The image
data is raw or PackBits behind its table of byte counts; each channel
starts where the counts put it, and its rows take whole packets, a
packet's bytes past its row dropped (Pillow's ``PackBitsDecode``).  As
``Image.open``: a depth outside ``MODES`` (16 bits, say) raises (the
plugin's ``KeyError``), so do too few channels and ZIP compression (no
tile); a PSB file (version 2) is not this format, and ``Image.open`` moves
on.

The PackBits stage is ``csrc/tiff_decode.cpp``'s (``psd_packbits``, the
loop it shares with ``tiff_packbits``), which the loaders call;
``packbits_plain`` is the same stage in Python.
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import rle, tiff

MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
         (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
         (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


class _Reader:
    """A file position that reads as Pillow's ``fp.read`` (short at the
    end) and unpacks as its ``i16``/``i32`` (``struct.error`` when short)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def i16(self) -> int:
        return struct.unpack(">H", self.read(2))[0]

    def i32(self) -> int:
        return struct.unpack(">I", self.read(4))[0]


def open_psd(data: bytes) -> dict:
    """``PsdImageFile._open``: the header and the image data's tiles;
    ``SyntaxError`` (``struct.error``, IndexError) where ``Image.open``
    moves on, ``ValueError`` where it raises."""
    s = data[:26]
    if len(s) < 6 or struct.unpack_from(">H", s, 4)[0] != 1:
        raise SyntaxError("not a PSD file")
    bits, channels, psd_mode = (struct.unpack_from(">H", s, k)[0]
                                for k in (22, 12, 24))
    if (psd_mode, bits) not in MODES:
        raise ValueError(f"unsupported PSD colour mode {psd_mode} at "
                         f"{bits} bits")
    mode, need = MODES[(psd_mode, bits)]
    if need > channels:
        raise ValueError("not enough channels")
    if mode == "RGB" and channels == 4:
        mode, need = "RGBA", 4
    h, w = struct.unpack_from(">II", s, 14)
    f = _Reader(data, 26)
    palette = np.zeros((0, 3), np.uint8) if mode == "P" else None
    size = f.i32()
    if size:
        body = f.read(size)
        if mode == "P" and size == 768:
            palette = np.frombuffer(body, np.uint8).reshape(3, 256).T.copy()
    size = f.i32()
    if size:  # image resources, walked as the plugin walks them
        end = f.pos + size
        while f.pos < end:
            f.read(4)
            f.i16()
            name = f.read(f.read(1)[0])
            if not len(name) & 1:
                f.read(1)
            body = f.read(f.i32())
            if len(body) & 1:
                f.read(1)
    size = f.i32()
    if size:  # layer and mask information: skipped
        end = f.pos + size
        f.i32()
        f.pos = end
    compression = f.i16()
    tiles = []
    if compression == 0:
        offset = f.pos
        for _ in range(need):
            tiles.append(offset)
            offset += w * h
    elif compression == 1:
        counts = f.read(need * h * 2)
        offset, i = f.pos, 0
        for _ in range(need):
            tiles.append(offset)
            for _ in range(h):
                offset += struct.unpack_from(">H", counts, i)[0]
                i += 2
    return dict(size=(w, h), mode=mode, channels=need,
                compression=compression, tiles=tiles, palette=palette)


def packbits_plain(data: bytes, row: int, rows: int) -> np.ndarray:
    """Pillow's ``PackBitsDecode``: (rows, row) bytes."""
    out = bytearray(row * rows)
    o, pos, n = 0, 0, len(data)
    while o < row * rows:
        if pos >= n:
            raise ValueError(rle.ERRORS[-1])
        c = data[pos]
        if c == 0x80:
            pos += 1
            continue
        end = (o // row + 1) * row
        if c & 0x80:
            if pos + 2 > n:
                raise ValueError(rle.ERRORS[-1])
            keep = min(257 - c, end - o)
            out[o:o + keep] = data[pos + 1:pos + 2] * keep
            pos += 2
        else:
            if pos + 2 + c > n:
                raise ValueError(rle.ERRORS[-1])
            keep = min(c + 1, end - o)
            out[o:o + keep] = data[pos + 1:pos + 1 + keep]
            pos += 2 + c
        o += keep
    return np.frombuffer(bytes(out), np.uint8).reshape(rows, row)


def packbits(data: bytes, row: int, rows: int) -> np.ndarray:
    """The C++ stage: ``packbits_plain``'s output."""
    out = np.zeros((rows, row), np.uint8)
    got = tiff._native().psd_packbits(data, len(data),
                                      out.ctypes.data_as(ctypes.c_void_p),
                                      row, rows)
    if got < 0:
        raise ValueError(rle.ERRORS[-1])
    return out


def load_psd(data: bytes, head: dict, plain: bool = False):
    """``(pixels, mode, palette, transparency)`` of an opened header."""
    (w, h), mode = head["size"], head["mode"]
    if head["compression"] not in (0, 1):
        raise ValueError(f"cannot load this image (PSD compression "
                         f"{head['compression']})")
    row = (w + 7) // 8 if mode == "1" else w
    planes = []
    for offset in head["tiles"]:
        if head["compression"] == 0:
            body = data[offset:offset + row * h]
            if len(body) < row * h:
                raise ValueError("image file is truncated")
            planes.append(np.frombuffer(body, np.uint8).reshape(h, row))
        else:
            dec = packbits_plain if plain else packbits
            planes.append(dec(data[offset:], row, h))
    if mode == "1":
        px = np.unpackbits(planes[0], axis=1)[:, :w] * np.uint8(255)
    elif len(planes) == 1:
        px = planes[0]
    else:
        px = np.stack(planes, -1)
        if mode == "CMYK":
            px = 255 - px
        elif mode == "LAB":  # a and b are signed: Pillow's unpacker flips 128
            px[..., 1:] ^= 0x80
    return np.ascontiguousarray(px), mode, head["palette"], None
