"""A Netpbm reader: PBM, PGM, PPM and PFM as Pillow's ``PpmImagePlugin``
opens them.

Every header of the plugin's ``MODES``: ``P1``-``P6`` (plain and raw),
``Pf`` (gray float, rows bottom to top, little-endian where the scale is
negative), and the extensions ``P0CMYK``, ``PyP`` (no palette: black),
``PyRGBA`` and ``PyCMYK``.  Header tokens are read as the plugin reads
them (whitespace-separated, ``#`` comments to the end of a line, at most
10 characters).  A gray file with a maxval past 255 opens as ``I``
(a maxval of 65535 as big-endian 16-bit values as they are); other
maxvals than 255 are scaled as the plugin scales them,
``min(top, round(v / maxval * top))`` (Python's rounding; ``top`` 65535
for ``I``, else 255); ``P1`` and ``P4`` give ``1`` with 1 as black.
"""
from __future__ import annotations

import math

import numpy as np

_WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
          b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
          b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


class _Header:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def magic(self) -> bytes:
        out = b""
        for _ in range(6):
            c = self.data[self.pos:self.pos + 1]
            self.pos += 1
            if not c or c in _WHITESPACE:
                break
            out += c
        return out

    def token(self) -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = self.data[self.pos:self.pos + 1]
            self.pos += 1
            if not c:
                break
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while self.data[self.pos:self.pos + 1] not in b"\r\n":
                    self.pos += 1
                self.pos += 1
                continue
            tok += c
        if not tok:
            raise ValueError("Reached EOF while reading header")
        if len(tok) > 10:
            raise ValueError("Token too long in file header")
        return tok


def _strip_comments(body: bytes) -> bytes:
    out, pos = [], 0
    while True:
        k = body.find(b"#", pos)
        if k < 0:
            out.append(body[pos:])
            return b"".join(out)
        out.append(body[pos:k])
        ends = [e for e in (body.find(b"\n", k), body.find(b"\r", k)) if e >= 0]
        if not ends:
            return b"".join(out)
        pos = min(ends) + 1


def _scale(values: np.ndarray, maxval: int, top: int) -> np.ndarray:
    # Python's round() of the double quotient: half to even
    q = values.astype(np.float64) / maxval * top
    return np.minimum(top, np.round(q)).astype(np.int64)


def decode(data: bytes, name: str = "PPM"):
    """``(pixels, mode, palette, transparency)`` as Pillow opens the file."""
    try:
        return _decode(data, name)
    except (ValueError, IndexError) as e:
        if str(e).startswith(f"{name}: "):
            raise
        raise ValueError(f"{name}: a corrupt Netpbm file ({e})") from None


def _decode(data: bytes, name: str):
    hdr = _Header(data)
    magic = hdr.magic()
    if magic not in _MODES:
        raise ValueError(f"{name}: not a PPM file")
    mode = _MODES[magic]
    w, h = int(hdr.token()), int(hdr.token())
    palette = np.zeros((0, 3), np.uint8) if mode == "P" else None
    if mode == "F":
        scale = float(hdr.token())
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("scale must be finite and non-zero")
        dt = "<f4" if scale < 0 else ">f4"
        body = data[hdr.pos:hdr.pos + 4 * w * h]
        if len(body) < 4 * w * h:
            raise ValueError("image file is truncated")
        px = np.frombuffer(body, dt).astype(np.float32).reshape(h, w)[::-1]
        return np.ascontiguousarray(px), "F", None, None
    body = data[hdr.pos:]
    if mode == "1":
        if magic == b"P1":
            toks = b"".join(_strip_comments(body).split())[:w * h]
            if len(toks) < w * h or set(toks) - {48, 49}:
                raise ValueError("image file is truncated or has an invalid "
                                 "token")
            bits = np.frombuffer(toks, np.uint8) - 48
            return np.where(bits.reshape(h, w) == 1, 0, 255).astype(
                np.uint8), "1", None, None
        stride = (w + 7) // 8
        if len(body) < stride * h:
            raise ValueError("image file is truncated")
        rows = np.frombuffer(body[:stride * h], np.uint8).reshape(h, stride)
        bits = np.unpackbits(rows, axis=1)[:, :w]
        return np.where(bits == 1, 0, 255).astype(np.uint8), "1", None, None
    maxval = int(hdr.token())
    body = data[hdr.pos:]
    if not 0 < maxval < 65536:
        raise ValueError("maxval must be greater than 0 and less than 65536")
    if maxval > 255 and mode == "L":
        mode = "I"
    bands = _BANDS[mode]
    n = w * h * bands
    top = 65535 if mode == "I" else 255
    if magic in (b"P2", b"P3"):
        toks = _strip_comments(body).split()[:n]
        if len(toks) < n:
            raise ValueError("image file is truncated")
        if any(len(t) > 10 for t in toks):
            raise ValueError("Token too long found in data")
        vals = np.array([int(t) for t in toks], np.int64)
        if (vals < 0).any() or (vals > maxval).any():
            raise ValueError("Channel value out of range")
        vals = _scale(vals, maxval, top)
    else:
        size = 1 if maxval < 256 else 2
        if len(body) < n * size:
            raise ValueError("image file is truncated")
        vals = np.frombuffer(body[:n * size], ">u2" if size == 2 else np.uint8)
        if not (maxval == 255 or (maxval == 65535 and mode == "I")):
            vals = _scale(vals, maxval, top)
    shape = (h, w) if bands == 1 else (h, w, bands)
    dt = np.int32 if mode == "I" else np.uint8
    return vals.astype(dt).reshape(shape), mode, palette, None
