"""An SGI reader: what Pillow's ``SgiImagePlugin`` gives.

``(bytes a channel, dimension, zsize)`` as the plugin's ``MODES``: 1 or 2
bytes a channel, ``L`` (dimension 1 or 2), ``RGB`` and ``RGBA`` (dimension
3); 2-byte files come out in the 8-bit mode, each sample its high byte
(``self._mode = rawmode.split(";")[0]``).  Raw files hold one plane a
channel; run-length files a table of each row's start and length per
channel after the 512-byte header.  Rows are stored bottom-up.  Any other
layout raises ``ValueError``, as the plugin's ``Unsupported SGI image
mode`` does; a compression other than 0 or 1 has no tile in Pillow, and
raises here.

The run-length stage runs in C++ (``data/rle.py``); ``rle_plain`` is the
same stage in Python.
"""
from __future__ import annotations

import struct

import numpy as np

from . import rle

MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B",
         (2, 2, 1): "L;16B", (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B",
         (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def open_sgi(data: bytes) -> dict:
    """``SgiImageFile._open``: the header; ``ValueError`` for a layout
    outside ``MODES`` (Pillow raises there), IndexError/``struct.error``
    where ``Image.open`` moves on."""
    compression, bpc = data[2], data[3]
    dim, xsize, ysize, zsize = struct.unpack_from(">4H", data, 4)
    rawmode = MODES.get((bpc, dim, zsize))
    if rawmode is None:
        raise ValueError(f"unsupported SGI image mode ({bpc} bytes a "
                         f"channel, dimension {dim}, {zsize} channels)")
    return dict(size=(xsize, ysize), mode=rawmode.split(";")[0], bpc=bpc,
                zsize=zsize, compression=compression)


def rle_plain(data: bytes, xsize: int, ysize: int, zsize: int, bpc: int,
              starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Pillow's ``SgiRleDecode``: (ysize, xsize * zsize * bpc) bytes, rows in
    file order, channels interleaved."""
    buf = data[512:]
    size = len(buf)
    if size < 8 * zsize * ysize:
        raise ValueError(rle.ERRORS[-2])
    stride = xsize * zsize * bpc
    line = bytearray(stride)
    out = np.zeros((ysize, stride), np.uint8)
    step = zsize * bpc
    for y in range(ysize):
        for z in range(zsize):
            src, n = int(starts[y + z * ysize]), int(lengths[y + z * ysize])
            if src < 512:
                raise ValueError(rle.ERRORS[-2])
            src -= 512
            x = 0
            while n > 0:
                if src + bpc - 1 > size - 1:
                    raise ValueError(rle.ERRORS[-2])
                c = buf[src + bpc - 1]
                src += bpc
                if n == 1 and c != 0:  # Pillow stops here, without an error
                    return out
                count = c & 0x7F
                if not count:
                    break
                if x + count > xsize:
                    raise ValueError(rle.ERRORS[-2])
                at = z * bpc + x * step
                if c & 0x80:
                    if src + bpc * count > size - 1:
                        raise ValueError(rle.ERRORS[-2])
                    for k in range(count):
                        line[at + k * step:at + k * step + bpc] = \
                            buf[src:src + bpc]
                        src += bpc
                else:
                    if src + bpc - 1 > size - 1:
                        raise ValueError(rle.ERRORS[-2])
                    for k in range(count):
                        line[at + k * step:at + k * step + bpc] = \
                            buf[src:src + bpc]
                    src += bpc
                x += count
                n -= 1
        out[y] = np.frombuffer(bytes(line), np.uint8)
    return out


def load_sgi(data: bytes, head: dict, plain: bool = False):
    """``(pixels, mode, palette, transparency)`` of an opened header."""
    (w, h), mode, bpc, z = head["size"], head["mode"], head["bpc"], \
        head["zsize"]
    if head["compression"] == 0:
        plane = w * h * bpc
        body = data[512:512 + plane * z]
        if len(body) < plane * z:
            raise ValueError("image file is truncated")
        px = np.frombuffer(body, np.uint8).reshape(z, h, w, bpc)[..., 0]
        px = np.moveaxis(px, 0, -1)
    elif head["compression"] == 1:
        n = h * z
        tabs = np.frombuffer(data[512:512 + 8 * n].ljust(8 * n, b"\0"), ">u4")
        rows = (rle_plain if plain else rle.sgi_rle)(
            data, w, h, z, bpc, tabs[:n].astype(np.uint32),
            tabs[n:].astype(np.uint32))
        px = rows.reshape(h, w, z, bpc)[..., 0]
    else:
        raise ValueError(f"cannot load this image (SGI compression "
                         f"{head['compression']})")
    px = px[::-1]
    if mode == "L":
        px = px[..., 0]
    return np.ascontiguousarray(px), mode, None, None
