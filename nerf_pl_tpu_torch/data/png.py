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
    """Undo the scanline filters.  Each reconstructed byte needs its left,
    upper and upper-left neighbours (``bpp`` bytes apart: one pixel), so the
    image is rebuilt in anti-diagonal wavefronts of pixels, ``x + y = d``,
    each pixel with its own row's filter: ``h + w - 1`` vector steps.  The
    image sits in a zero-padded ``(h + 1, w + 1)`` grid, flattened, where a
    wavefront is the strided slice ``[s : e : w]`` and its left, upper and
    upper-left neighbours are that slice moved by 1, ``w + 1`` and ``w + 2``
    rows of the flat grid."""
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    W1 = w + 1
    grid = np.zeros(((h + 1) * W1, bpp), np.int16)
    filt = np.zeros((h + 1) * W1, np.uint8)
    line = np.zeros(((h + 1) * W1, bpp), np.int16)
    line.reshape(h + 1, W1, bpp)[1:, 1:] = rows[:, 1:].reshape(h, w, bpp)
    filt.reshape(h + 1, W1)[1:, 1:] = ftype[:, None]
    paeth_rows = bool((ftype == 4).any())
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)  # rows on this wavefront
        start = (y0 + 1) * W1 + (d - y0) + 1
        stop = start + (y1 - y0 - 1) * w + 1
        a = grid[start - 1:stop - 1:w]
        b = grid[start - W1:stop - W1:w]
        c = grid[start - W1 - 1:stop - W1 - 1:w]
        if paeth_rows:
            # the neighbour nearest a + b - c, ties to a, then b
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            paeth = np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, c))
        else:
            paeth = c
        pred = np.choose(filt[start:stop:w, None],
                         (np.zeros_like(a), a, b, (a + b) >> 1, paeth))
        grid[start:stop:w] = (line[start:stop:w] + pred) & 0xFF
    return grid.reshape(h + 1, W1, bpp)[1:, 1:].astype(np.uint8).reshape(
        h, stride)


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
