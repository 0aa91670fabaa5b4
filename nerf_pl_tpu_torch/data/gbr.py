"""A GIMP brush reader: what Pillow's ``GbrImagePlugin`` gives: a
big-endian header (its size, version 1 or 2, width, height, bytes a pixel
1 or 4; version 2 adds ``GIMP`` and the spacing), the comment up to the
header's end, then ``L`` or ``RGBA`` bytes."""
from __future__ import annotations

import struct

from . import unpack


def open_gbr(data: bytes) -> dict:
    def i32(k):
        return struct.unpack(">I", data[4 * k:4 * k + 4])[0]

    header_size = i32(0)
    if header_size < 20:
        raise SyntaxError("not a GIMP brush")
    version = i32(1)
    if version not in (1, 2):
        raise SyntaxError(f"Unsupported GIMP brush version: {version}")
    width, height, depth = i32(2), i32(3), i32(4)
    if width == 0 or height == 0:
        raise SyntaxError("not a GIMP brush")
    if depth not in (1, 4):
        raise SyntaxError(f"Unsupported GIMP brush color depth: {depth}")
    if version == 1:
        comment = header_size - 20
        pos = 20
    else:
        comment = header_size - 28
        if data[20:24] != b"GIMP":
            raise SyntaxError("not a GIMP brush, bad magic number")
        i32(6)  # the spacing: Pillow reads it, and a cut file moves on
        pos = 28
    # a negative comment length reads the rest of the file
    offset = pos + comment if comment >= 0 else len(data)
    return dict(size=(width, height), mode="L" if depth == 1 else "RGBA",
                offset=min(offset, len(data)))


def load_gbr(data: bytes, head: dict):
    (w, h), mode = head["size"], head["mode"]
    body = data[head["offset"]:head["offset"] + w * h * len(mode)]
    return unpack.set_as_raw(body, (w, h), mode, mode), mode, None, None
