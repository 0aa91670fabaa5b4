"""A PNG reader and writer on ``zlib`` alone, and PIL's ``convert("L")``.

Reads 8-bit, non-interlaced PNGs of colour types 0 (gray), 2 (RGB),
4 (gray + alpha) and 6 (RGBA), with the five scanline filters; anything else
raises ``ValueError``.  Writes the same four types, filter 0.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (PIL mode, channels)
_TYPES = {0: ("L", 1), 2: ("RGB", 3), 4: ("LA", 2), 6: ("RGBA", 4)}
_CHANNELS = {c: t for t, (_, c) in _TYPES.items()}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError("truncated PNG chunk")
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub
            cur = line.copy()
            for x in range(bpp, stride, bpp):  # bpp lanes at a time
                cur[x:x + bpp] = (cur[x:x + bpp] + cur[x - bpp:x]) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: each byte needs its left one
            cur_l, up = line.tolist(), prev.tolist()
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur_l[x] = (cur_l[x] + pred) & 0xFF
            cur = np.asarray(cur_l, np.int32)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str):
    """``(array (H, W[, C]) uint8, mode)`` with mode ``L``, ``LA``, ``RGB``
    or ``RGBA`` (the array has no channel axis for ``L``)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _TYPES or comp != 0 or filt != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour "
                         f"type {ctype}); only 8-bit gray, gray+alpha, RGB "
                         f"and RGBA are read")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    mode, ch = _TYPES[ctype]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch)
    pix = pix.reshape(h, w, ch)
    return (pix[..., 0] if ch == 1 else pix), mode


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 ``(H, W)`` gray or ``(H, W, C)`` image, C in 1..4."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _CHANNELS:
        raise ValueError(f"cannot write an image of shape {img.shape}")
    h, w, ch = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _CHANNELS[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def to_luma(img: np.ndarray, mode: str) -> np.ndarray:
    """PIL's ``convert("L")``: gray as is; RGB(A) in PIL's fixed point,
    ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``."""
    if mode == "L":
        return img
    if mode == "LA":
        return img[..., 0]
    rgb = img[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def to_rgba(img: np.ndarray, mode: str) -> np.ndarray:
    """PIL's ``convert("RGBA")`` for the four modes."""
    if mode == "RGBA":
        return img
    h, w = img.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    if mode == "RGB":
        out[..., :3], out[..., 3] = img, 255
    elif mode == "L":
        out[..., :3], out[..., 3] = img[..., None], 255
    else:  # LA
        out[..., :3], out[..., 3] = img[..., :1], img[..., 1]
    return out
