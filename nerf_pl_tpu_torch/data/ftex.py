"""An FTEX reader: what Pillow's ``FtexImagePlugin`` gives: a little-endian
header (version, size, mipmaps, one format), the format's offset, and the
first mip level's size and bytes: format 0 is DXT1 to ``RGBA`` through the
``bcn`` decoder (``data/dds.py``'s BC1 stage), format 1 ``RGB`` bytes."""
from __future__ import annotations

import struct

from . import dds, unpack


def open_ftex(data: bytes) -> dict:
    struct.unpack("<i", data[4:8])  # the version: a cut file moves on
    size = struct.unpack("<2i", data[8:16])
    _, formats = struct.unpack("<2i", data[16:24])
    if formats != 1:
        raise ValueError(f"an FTEX file of {formats} formats (Pillow asserts "
                         "one)")
    fmt, where = struct.unpack("<2i", data[24:32])
    if where < 0:
        raise ValueError("an FTEX format offset before the file")
    (length,) = struct.unpack("<i", data[where:where + 4])
    body = data[where + 4:] if length < 0 else data[where + 4:where + 4
                                                    + length]
    if fmt not in (0, 1):
        raise ValueError(f"Invalid texture compression format: {fmt}")
    return dict(size=size, mode="RGBA" if fmt == 0 else "RGB", body=body)


def load_ftex(data: bytes, head: dict):
    (w, h), body = head["size"], head["body"]
    if head["mode"] == "RGBA":
        return dds.decode_blocks(body, 1, 0, w, h), "RGBA", None, None
    return unpack.raw(body, 0, (w, h), "RGB", "RGB"), "RGB", None, None
