"""A BMP reader: what Pillow's ``BmpImagePlugin`` gives.

Core (12-byte), info (40, 52, 56, 64) and v4/v5 (108, 124) headers; 1, 4
and 8-bit palettes (a palette that is the gray ramp gives ``L``, and two
entries black and white give ``1``, as the plugin decides; other palettes
``P``); 16-bit (5-5-5), 24- and 32-bit pixels, with ``BI_BITFIELDS`` in
the masks the plugin supports (an alpha mask gives ``RGBA``); RLE8 and
RLE4 (``BmpRleDecoder``, with its reading of a delta escape, which skips
two bytes and takes the next two as the move); rows bottom-up, or
top-down where the height is negative.  A gray ramp palette on 1-bit data
of more than two entries or on 4-bit data raises (Pillow reads such data
as 8-bit samples).
"""
from __future__ import annotations

import struct

import numpy as np

_BITFIELDS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}


def _i32(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0]


def _i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """``BmpRleDecoder``: the indices in file order (bottom row first)."""
    out = bytearray()
    x, n, total = 0, len(data), w * h
    while len(out) < total:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:
            out += b"\x00" * (-len(out) % w)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > n:
                break
            pos += 2
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += b"\x00" * (right + up * w)
            x = len(out) % w
        else:
            nbytes = byte // 2 if rle4 else byte
            chunk = data[pos:pos + nbytes]
            pos += len(chunk)
            if rle4:
                for b in chunk:
                    out += bytes([b >> 4, b & 15])
            else:
                out += chunk
            if len(chunk) < nbytes:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(out) < total:
        raise ValueError("not enough image data")
    return np.frombuffer(bytes(out[:total]), np.uint8).reshape(h, w)


def _unpack(raw: str, rows: np.ndarray, w: int) -> np.ndarray:
    """(h, stride) row bytes -> pixels of the raw mode's unpacker."""
    h = rows.shape[0]
    if raw in ("P;1", "P;4"):
        bits = 1 if raw == "P;1" else 4
        v = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(h, w, bits)
        return (v * (1 << np.arange(bits - 1, -1, -1))).sum(-1).astype(np.uint8)
    if raw in ("P", "L"):
        return rows[:, :w]
    if raw in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * w].copy().view("<u2").astype(np.int32)
        if raw == "BGR;15":
            r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
            g = g * 255 // 31
        else:
            r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
            g = g * 255 // 63
        return np.stack([r * 255 // 31, g, b * 255 // 31], -1).astype(np.uint8)
    size = len(raw)
    px = rows[:, :size * w].reshape(h, w, size)
    order = {c: i for i, c in enumerate(raw)}
    out = [px[..., order[c]] for c in "RGB"]
    if "A" in raw:
        out.append(px[..., order["A"]])
    return np.stack(out, -1)


def decode(data: bytes, name: str = "BMP"):
    """``(pixels, mode, palette, transparency)`` as Pillow opens the file."""
    return _guarded(lambda: _bitmap(data, name, 14, _i32(data, 10))[:4], name)


def decode_dib(data: bytes, name: str = "DIB", header: int = 0,
               halve: bool = False, raw_alpha: bool = False):
    """A DIB (a BMP without its 14-byte file header, as in ICO and CUR
    files and Pillow's ``DibImageFile``) whose header starts at ``header``,
    its pixels right after the header, masks and palette.  ``halve`` keeps
    the first half of the rows (the XOR image of an icon or cursor), and
    ``raw_alpha`` reads 32-bit pixels as ``BGRA`` (Pillow's 32-bit ``.cur``
    at offset 22).  Returns ``(pixels, mode, palette, transparency)`` and
    the pixel data's offset."""
    return _guarded(lambda: _bitmap(data, name, header, 0, halve, raw_alpha),
                    name)


def _guarded(fn, name: str):
    try:
        return fn()
    except (struct.error, IndexError, ValueError) as e:
        if str(e).startswith(f"{name}: "):
            raise
        raise ValueError(f"{name}: a corrupt BMP ({e})") from None


def _bitmap(data: bytes, name: str, start: int, offset: int,
            halve: bool = False, raw_alpha: bool = False):
    """``BmpImageFile._bitmap``: the header at ``start``, the pixels at
    ``offset`` (0: where the header, masks and palette end)."""
    hsize = _i32(data, start)
    hd = data[start + 4:start + hsize]
    if len(hd) < hsize - 4:
        raise ValueError("truncated header")
    pos = start + hsize
    direction = -1
    if hsize == 12:
        w, h, bits = _i16(hd, 0), _i16(hd, 2), _i16(hd, 6)
        comp, colors, pad = 0, 0, 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        flip = hd[7] == 0xFF
        direction = 1 if flip else -1
        w = _i32(hd, 0)
        h = 2 ** 32 - _i32(hd, 4) if flip else _i32(hd, 4)
        bits, comp, colors, pad = _i16(hd, 10), _i32(hd, 12), _i32(hd, 28), 4
        if comp == 3:
            if len(hd) >= 48:
                masks = [_i32(hd, 36 + 4 * k) for k in range(3)]
                masks.append(_i32(hd, 48) if len(hd) >= 52 else 0)
            else:
                masks = [_i32(data, pos + 4 * k) for k in range(3)] + [0]
                pos += 12
    else:
        raise ValueError(f"{name}: unsupported BMP header type ({hsize})")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in _RAW:
        raise ValueError(f"{name}: unsupported BMP pixel depth ({bits})")
    mode, raw = ("P" if bits <= 8 else "RGB"), _RAW[bits]
    rle = False
    if comp == 3:
        key = (bits, tuple(masks)) if bits == 32 else (bits, tuple(masks[:3]))
        if key not in _BITFIELDS:
            raise ValueError(f"{name}: unsupported BMP bitfields layout")
        raw = _BITFIELDS[key]
        mode = "RGBA" if "A" in raw else mode
    elif comp in (1, 2):
        rle = True
    elif comp != 0:
        raise ValueError(f"{name}: unsupported BMP compression ({comp})")
    elif bits == 32 and raw_alpha:
        raw, mode = "BGRA", "RGBA"
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: unsupported BMP palette size ({colors})")
        pal = np.frombuffer(data[pos:pos + pad * colors], np.uint8)
        pos += len(pal)
        pal = pal[:len(pal) // pad * pad].reshape(-1, pad)[:, :3]
        ramp = [0, 255] if colors == 2 else list(range(colors))
        gray = len(pal) >= len(ramp) and all(
            (pal[i] == v).all() for i, v in enumerate(ramp))
        if gray:
            mode = "1" if colors == 2 else "L"
            if (mode == "1" and bits != 1) or (mode == "L" and bits != 8):
                raise ValueError(f"{name}: a gray palette on {bits}-bit data "
                                 "(Pillow reads it as 8-bit samples)")
            raw = "P;1" if mode == "1" else "L"
        else:
            palette = pal[:, ::-1].copy()
    offset = offset or min(pos, len(data))
    if halve:
        h //= 2
    if rle:
        px = _rle(data, offset, w, h, comp == 2)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        body = data[offset:offset + stride * h]
        if len(body) < stride * h:
            raise ValueError("image file is truncated")
        px = _unpack(raw, np.frombuffer(body, np.uint8).reshape(h, stride), w)
    if direction == -1:
        px = px[::-1]
    px = np.ascontiguousarray(px)
    if mode == "1":
        px = (px * 255).astype(np.uint8)
    return px, mode, palette, None, offset
