"""An FLI/FLC reader: frame 0 as Pillow's ``FliImagePlugin`` gives it.

The 128-byte header (magic 0xAF11 or 0xAF12, the zeroed fields Pillow
checks, at least one frame), the palette of the first frame's first
COLOR chunk (11: 6-bit values shifted up by 2, each masked to 8 bits; 4:
8-bit; packets that skip and copy entries; a gray ramp elsewhere), then
the frame chunk at byte 128 decoded on a zeroed ``P`` image: BLACK (13),
BRUN (15), COPY (16), LC (12) and SS2 (7), as Pillow's ``fli`` decoder
does.  The decoder sees what Pillow's reads hand it: the frame's size of
bytes, again and again until it holds the frame.  The frame stage runs in
C++ (``data/rle.py``); ``frame_plain`` is the same stage in Python.
"""
from __future__ import annotations

import struct

import numpy as np

from . import rle


def _i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _i32(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0]


def _palette(data: bytes, pos: int, palette: list, shift: int) -> None:
    """``FliImageFile._palette``: packets of (skip, count, RGB * count)."""
    count = _i16(data[pos:pos + 2])
    pos += 2
    i = 0
    for _ in range(count):
        s = data[pos:pos + 2]
        pos += len(s)
        i += s[0]
        n = s[1] or 256
        s = data[pos:pos + 3 * n]
        pos += len(s)
        for k in range(0, len(s), 3):
            if len(s) - k < 3:
                raise IndexError("a cut palette entry")
            palette[i] = tuple((v << shift) & 255 for v in s[k:k + 3])
            i += 1


def open_fli(data: bytes) -> dict:
    s = data[:128]
    if not (len(s) >= 16 and _i16(s, 4) in (0xAF11, 0xAF12)
            and _i16(s, 14) in (0, 3) and s[20:22] == b"\0\0"
            and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise SyntaxError("not an FLI/FLC file")
    frames = _i16(s, 6)
    size = _i16(s, 8), _i16(s, 10)
    palette = [(a, a, a) for a in range(256)]
    pos = 128
    s = data[pos:pos + 16]
    pos += len(s)
    if _i16(s, 4) == 0xF100:  # a prefix chunk
        pos = 128 + _i32(s)
        s = data[pos:pos + 16]
        pos += len(s)
    if _i16(s, 4) == 0xF1FA:  # the first frame's COLOR chunk
        chunk_size = None
        for _ in range(_i16(s, 6)):
            if chunk_size is not None:
                pos += chunk_size - 6
                if pos < 0:
                    raise ValueError("an FLI chunk size before the file")
            s = data[pos:pos + 6]
            pos += len(s)
            kind = _i16(s, 4)
            if kind in (4, 11):
                _palette(data, pos, palette, 2 if kind == 11 else 0)
                break
            chunk_size = _i32(s)
            if not chunk_size:
                break
    if frames == 0:
        raise EOFError("attempt to seek outside sequence")
    head = data[128:132]
    if not head:
        raise EOFError("missing frame size")
    return dict(size=size, mode="P", framesize=_i32(head),
                palette=np.array(palette, np.uint8))


def _frame_bytes(data: bytes, framesize: int) -> bytes:
    """The bytes Pillow's ``fli`` decoder holds when it decodes frame 0:
    ``framesize`` more at each read, until they are a whole frame."""
    rest = data[128:]
    held = 0
    while True:
        if framesize <= 0 or held >= len(rest):
            raise ValueError(rle.ERRORS[-1])
        held = min(held + framesize, len(rest))
        b = rest[:held]
        if held >= 4 and held + held % 2 >= struct.unpack_from("<i", b)[0]:
            return b


def frame_plain(buf: bytes, w: int, h: int) -> np.ndarray:
    """Pillow's ``FliDecode`` on one frame chunk: (h, w) P indices."""
    im = np.zeros((h, w), np.uint8)
    n = len(buf)

    def err(rc):
        return ValueError(rle.FLI_ERRORS[rc])

    if n < 8:
        raise err(-2)
    if _i16(buf, 4) != 0xF1FA:
        raise err(-3)
    chunks, ptr, end = _i16(buf, 6), 16, n

    for _ in range(chunks):
        if end - ptr < 10:
            raise err(-2)
        d = ptr + 6

        def oob(k):
            if d + k > end:
                raise err(-2)

        kind = _i16(buf, ptr + 4)
        if kind in (4, 11, 18):
            pass
        elif kind == 7:  # SS2
            lines = _i16(buf, d)
            d += 2
            l = y = 0
            while l < lines and y < h:
                row = y
                oob(2)
                packets = _i16(buf, d)
                d += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= h:
                            raise err(-2)
                        row = y
                    else:
                        im[row, w - 1] = packets & 0xFF
                    oob(2)
                    packets = _i16(buf, d)
                    d += 2
                p = x = 0
                while p < packets:
                    oob(2)
                    x += buf[d]
                    if buf[d + 1] >= 128:
                        oob(4)
                        k = 256 - buf[d + 1]
                        if x + 2 * k > w:
                            break
                        im[row, x:x + 2 * k] = np.tile(
                            np.frombuffer(buf, np.uint8, 2, d + 2), k)
                        x += 2 * k
                        d += 4
                    else:
                        k = 2 * buf[d + 1]
                        if x + k > w:
                            break
                        oob(2 + k)
                        im[row, x:x + k] = np.frombuffer(buf, np.uint8, k,
                                                         d + 2)
                        d += 2 + k
                        x += k
                    p += 1
                if p < packets:
                    break
                l, y = l + 1, y + 1
            if l < lines:
                raise err(-2)
        elif kind == 12:  # LC
            y = _i16(buf, d)
            ymax = y + _i16(buf, d + 2)
            d += 4
            while y < ymax and y < h:
                oob(1)
                packets = buf[d]
                d += 1
                p = x = 0
                while p < packets:
                    oob(2)
                    x += buf[d]
                    if buf[d + 1] & 0x80:
                        k = 256 - buf[d + 1]
                        if x + k > w:
                            break
                        oob(3)
                        im[y, x:x + k] = buf[d + 2]
                        d += 3
                    else:
                        k = buf[d + 1]
                        if x + k > w:
                            break
                        oob(2 + k)
                        im[y, x:x + k] = np.frombuffer(buf, np.uint8, k,
                                                       d + 2)
                        d += 2 + k
                    p, x = p + 1, x + k
                if p < packets:
                    break
                y += 1
            if y < ymax:
                raise err(-2)
        elif kind == 13:  # BLACK
            im[:] = 0
        elif kind == 15:  # BRUN
            for y in range(h):
                d += 1
                x = 0
                while x < w:
                    oob(2)
                    if buf[d] & 0x80:
                        k = 256 - buf[d]
                        if x + k > w:
                            break
                        oob(k + 1)
                        im[y, x:x + k] = np.frombuffer(buf, np.uint8, k,
                                                       d + 1)
                        d += k + 1
                    else:
                        k = buf[d]
                        if x + k > w:
                            break
                        im[y, x:x + k] = buf[d + 1]
                        d += 2
                    x += k
                if x != w:
                    raise err(-2)
        elif kind == 16:  # COPY
            if d + w * h > end:
                raise err(-1)
            im[:] = np.frombuffer(buf, np.uint8, w * h, d).reshape(h, w)
        else:
            raise err(-3)
        advance = struct.unpack_from("<i", buf, ptr)[0]
        if advance == 0:
            raise err(-4)
        if advance < 0 or advance > end - ptr:
            raise err(-2)
        ptr += advance
    return im


def load_fli(data: bytes, head: dict, plain: bool = False):
    (w, h) = head["size"]
    buf = _frame_bytes(data, head["framesize"])
    px = (frame_plain if plain else rle.fli_frame)(buf, w, h)
    return px, "P", head["palette"], None
