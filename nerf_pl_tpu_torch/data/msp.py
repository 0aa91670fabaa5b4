"""A Windows Paint (MSP) reader: what Pillow's ``MspImagePlugin`` gives.

A 32-byte header of little-endian words whose XOR is 0; ``DanM`` (v1)
holds ``1`` rows raw from byte 32, ``LinS`` (v2) a row map and run-length
rows (``MspDecoder``: a 0 type byte, then a count and a value; any other,
that many literal bytes; an empty row is white).  Pillow joins the
decoded rows and reads them as one raw ``1`` stream, rows of
``ceil(w / 8)`` bytes, so a row that decodes longer or shorter shifts the
rest.  The v2 stage runs in C++ (``data/rle.py``); ``rows_plain`` is the
same stage in Python.
"""
from __future__ import annotations

import struct

from . import rle, unpack


def open_msp(data: bytes) -> dict:
    s = data[:32]
    if s[:4] not in (b"DanM", b"LinS"):
        raise SyntaxError("not an MSP file")
    checksum = 0
    for i in range(0, 32, 2):
        checksum ^= struct.unpack_from("<H", s, i)[0]
    if checksum:
        raise SyntaxError("bad MSP checksum")
    return dict(size=struct.unpack_from("<HH", s, 4), mode="1",
                v2=s[:4] == b"LinS")


def rows_plain(data: bytes, w: int, h: int, cap: int) -> tuple:
    """Pillow's ``MspDecoder``: (the first ``cap`` joined bytes, the count
    of all)."""
    try:
        rowmap = struct.unpack_from(f"<{h}H", data[32:32 + 2 * h])
    except struct.error:
        raise ValueError(rle.MSP_ERRORS[-1]) from None
    out, pos = bytearray(), 32 + 2 * h
    blank = b"\xff" * ((w + 7) // 8)
    for rowlen in rowmap:
        if rowlen == 0:
            out += blank
            continue
        row = data[pos:pos + rowlen]
        pos += rowlen
        if len(row) != rowlen:
            raise ValueError(rle.MSP_ERRORS[-3])
        i = 0
        while i < rowlen:
            kind = row[i]
            i += 1
            if kind == 0:
                if i + 2 > rowlen:
                    raise ValueError(rle.MSP_ERRORS[-4])
                out += row[i + 1:i + 2] * row[i]
                i += 2
            else:
                out += row[i:i + kind]
                i += kind
    return bytes(out[:cap]), len(out)


def load_msp(data: bytes, head: dict, plain: bool = False):
    (w, h) = head["size"]
    if not head["v2"]:
        return unpack.raw(data, 32, (w, h), "1", "1"), "1", None, None
    need = h * ((w + 7) // 8)
    body, _ = (rows_plain if plain else rle.msp_rows)(data, w, h, need)
    return unpack.set_as_raw(body, (w, h), "1", "1"), "1", None, None
