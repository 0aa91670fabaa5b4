"""A GIF reader: frame 0, as Pillow's ``GifImagePlugin`` loads it.

The mode is ``P`` where the frame has a palette (its local table, else the
global one) that is not the identity gray ramp, else ``L``; the canvas is
the logical screen (grown to hold the frame where it reaches past it),
filled with the frame's transparency index where it has one and with 0
elsewhere, and the frame's LZW codes (lowest bit first, 2-12 bits, no
early change) are drawn into its rectangle, interlaced rows in their four
passes.  ``transparency`` is frame 0's Graphic Control index, as Pillow's
``info["transparency"]``.  The screen's background index is not kept:
Pillow reads it only to dispose of a frame, and frame 0 is the only one
read.
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np


def _palette_needed(p: bytes) -> bool:
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2])
               for i in range(0, len(p) - 2, 3))


def _blocks(data: bytes, pos: int):
    """The concatenated sub-blocks from ``pos``, and the position after the
    terminating empty block."""
    out = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            break
        out.append(data[pos:pos + n])
        pos += n
    return b"".join(out), pos


def _lzw(codes: bytes, bits: int, count: int) -> np.ndarray:
    """Up to ``count`` indices from GIF LZW data of minimum code size
    ``bits``."""
    clear, end = 1 << bits, (1 << bits) + 1
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(clear)] + [b"", b""]
    width, acc, nacc, pos, prev = bits + 1, 0, 0, 0, None
    n = len(codes)
    while len(out) < count:
        while nacc < width and pos < n:
            acc |= codes[pos] << nacc
            nacc += 8
            pos += 1
        if nacc < width:
            break
        code = acc & ((1 << width) - 1)
        acc >>= width
        nacc -= width
        if code == clear:
            table = table[:clear + 2]
            width, prev = bits + 1, None
            continue
        if code == end:
            break
        if prev is None:
            if code >= len(table):
                break
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(table[prev] + entry[:1])
        elif code == len(table) and len(table) < 4096:
            entry = table[prev] + table[prev][:1]
            table.append(entry)
        else:
            break
        out += entry
        prev = code
        if len(table) == (1 << width) and width < 12:
            width += 1
    return np.frombuffer(bytes(out[:count]), np.uint8)


def _interlaced_rows(h: int) -> np.ndarray:
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                           np.arange(2, h, 4), np.arange(1, h, 2)])


def _read(data: bytes, name: str):
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{name}: not a GIF file")
    w, h = struct.unpack("<HH", data[6:10])
    flags = data[10]
    pos = 13
    global_pal: Optional[bytes] = None
    if flags & 128:
        p = data[pos:pos + (3 << ((flags & 7) + 1))]
        pos += len(p)
        if _palette_needed(p):
            global_pal = p
    transparency = None
    while True:
        if pos >= len(data) or data[pos:pos + 1] == b";":
            raise ValueError(f"{name}: image not found in GIF frame")
        s = data[pos]
        pos += 1
        if s == 0x21:
            label = data[pos]
            pos += 1
            first = True
            while True:
                n = data[pos] if pos < len(data) else 0
                pos += 1
                if n == 0:
                    break
                block = data[pos:pos + n]
                pos += n
                if first and label == 249 and block and block[0] & 1:
                    transparency = block[3]
                first = False
        elif s == 0x2C:
            x0, y0, fw, fh, fflags = struct.unpack("<HHHHB", data[pos:pos + 9])
            pos += 9
            palette = global_pal
            if fflags & 128:
                p = data[pos:pos + (3 << ((fflags & 7) + 1))]
                pos += len(p)
                palette = p if _palette_needed(p) else None
            interlace = bool(fflags & 64)
            bits = data[pos]
            pos += 1
            codes, pos = _blocks(data, pos)
            break
        # any other byte is skipped, as the plugin's loop skips it
    cw, ch = max(w, x0 + fw), max(h, y0 + fh)
    canvas = np.full((ch, cw), transparency or 0, np.uint8)
    if not 1 <= bits <= 12:
        raise ValueError(f"{name}: bad GIF code size {bits}")
    idx = _lzw(codes, bits, fw * fh)
    full = np.zeros(fw * fh, np.uint8)
    full[:len(idx)] = idx
    frame = full.reshape(fh, fw)
    n_rows = -(-len(idx) // fw) if fw else 0
    rows = _interlaced_rows(fh) if interlace else np.arange(fh)
    rows = rows[:n_rows]
    canvas[y0 + rows, x0:x0 + fw] = frame[:n_rows]
    mode = "P" if palette is not None else "L"
    pal = (np.frombuffer(palette, np.uint8).reshape(-1, 3)
           if palette is not None else None)
    return canvas, mode, pal, transparency


def decode(data: bytes, name: str = "GIF"):
    """``(pixels, mode, palette, transparency)`` as Pillow opens frame 0."""
    try:
        return _read(data, name)
    except (struct.error, IndexError) as e:
        raise ValueError(f"{name}: a corrupt GIF ({e})") from None
