"""An Intel DCX reader: frame 0 as Pillow's ``DcxImagePlugin`` gives it:
the magic, a directory of up to 1024 offsets ended by a 0, and the first
one's PCX read by ``data/pcx.py`` (its palette, where it has one, still
from the end of the whole file)."""
from __future__ import annotations

import struct

from . import pcx


def open_dcx(data: bytes) -> dict:
    offsets = []
    for i in range(1, 1025):
        offset = struct.unpack("<I", data[4 * i:4 * i + 4])[0]
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise EOFError("attempt to seek outside sequence")
    frame = data[offsets[0]:]
    if not pcx._accept(frame[:68]):
        raise SyntaxError("not a PCX file")
    head = pcx.open_pcx(frame)
    head["offset"] = offsets[0]
    return head


def load_dcx(data: bytes, head: dict):
    return pcx.load_pcx(data[head["offset"]:], head)
