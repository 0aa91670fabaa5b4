"""A PIXAR reader: what Pillow's ``PixarImagePlugin`` gives: a 512-byte
header (size little-endian at 418 and 416), ``RGB`` where the channel and
depth words (424, 426) are 14 and 2 (any other: no mode, the next format
tries), the pixels raw from byte 1024."""
from __future__ import annotations

import struct

from . import unpack


def open_pixar(data: bytes) -> dict:
    s = data[:512]
    size = struct.unpack_from("<H", s, 418)[0], struct.unpack_from(
        "<H", s, 416)[0]
    kind = struct.unpack_from("<HH", s, 424)
    return dict(size=size, mode="RGB" if kind == (14, 2) else "")


def load_pixar(data: bytes, head: dict):
    return unpack.raw(data, 1024, head["size"], "RGB", "RGB"), "RGB", None, \
        None
