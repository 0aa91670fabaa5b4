"""Pillow's raw decoder and the unpackers of ``Unpack.c`` that the IM, SUN,
MCIDAS, FITS, SPIDER, PIXAR, GBR, XVTHUMB, XBM and MSP readers name.

``raw(data, offset, size, mode, rawmode, stride, ystep)`` is Pillow's
``raw`` tile: rows of ``ceil(w * bits / 8)`` bytes from ``offset``, each
``stride`` bytes after the last where a stride is given (the last row
needs no padding), bottom to top where ``ystep`` is -1; a file that ends
first raises ``image file is truncated``, a stride below the row's bytes
raises as Pillow's decoder configuration error.  ``unpack(mode, rawmode,
rows, w)`` is one rawmode on ``(h, row bytes)`` uint8 rows, into the
picture's pixels (``1`` as 0/255, ``I;16*`` as uint16 values, ``I`` as
int32, ``F`` as float32).  The layouts:

  * bits: ``1`` (MSB first, 1 white), ``1;I`` (0 white), ``1;R`` (LSB
    first); ``L;4`` (nibbles, high first, times 17), ``P;2`` and ``P;4``
    (indices, high first);
  * bytes: ``L``, ``P``, ``RGB``, ``BGR``, ``RGBX``, ``BGRX``, ``RGBA``,
    ``CMYK``, ``LA``, ``YCbCr``, and ``BGR`` into ``RGBA`` (alpha 255);
  * line-interleaved (each row one plane after another): ``RGB;L``,
    ``RGBX;L`` (the X plane dropped), ``RGBA;L``, ``CMYK;L``, ``LA;L``,
    ``PA;L``, ``YCbCr;L``; one band of ``RGB``: ``R``, ``G``, ``B`` (the
    others left as they are);
  * words: ``I;16``/``I;16L`` little-endian, ``I;16B`` big-endian,
    ``I;32``/``I;32S`` little-endian unsigned/signed, ``I;32B``
    big-endian (both wrapped into int32), ``I`` (native: little-endian);
    ``F;8``, ``F;8S``, ``F;16``, ``F;16S``, ``F;32``, ``F;32S`` (integers
    as floats), ``F;32F``/``F`` and ``F;32BF`` (floats), ``F;64F`` and
    ``F;64BF`` (doubles rounded to float32).

``bit_decode`` is Pillow's ``bit`` decoder, which IM's ``L*N image``
types name.  What Pillow's unpacker table lacks for the image's mode
(``RLB``, ``PA;L`` into ``LA``) raises ``unknown raw mode``, as there.
"""
from __future__ import annotations

import numpy as np

TRUNCATED = "image file is truncated"

_WORDS = {  # rawmode: (numpy dtype of the file's values, picture dtype)
    "I;16": ("<u2", np.uint16), "I;16L": ("<u2", np.uint16),
    "I;16B": (">u2", np.uint16), "I": ("<i4", np.int32),
    "I;32": ("<u4", np.int32), "I;32S": ("<i4", np.int32),
    "I;32B": (">u4", np.int32),
    "F;8": ("u1", np.float32), "F;8S": ("i1", np.float32),
    "F;16": ("<u2", np.float32), "F;16S": ("<i2", np.float32),
    "F;32": ("<u4", np.float32), "F;32S": ("<i4", np.float32),
    "F": ("<f4", np.float32), "F;32F": ("<f4", np.float32),
    "F;32BF": (">f4", np.float32), "F;64F": ("<f8", np.float32),
    "F;64BF": (">f8", np.float32),
}
_WORD_MODES = {"I;16": "I;16", "I;16L": "I;16L", "I;16B": "I;16B"}
_PLANES = {"RGB;L": 3, "RGBX;L": 4, "RGBA;L": 4, "CMYK;L": 4, "LA;L": 2,
           "PA;L": 2, "YCbCr;L": 3}
_BYTES = {"L": 1, "P": 1, "RGB": 3, "BGR": 3, "RGBX": 4, "BGRX": 4,
          "RGBA": 4, "CMYK": 4, "LA": 2, "PA": 2, "YCbCr": 3}
_BITS = {"1": 1, "1;I": 1, "1;R": 1, "L;4": 4, "P;4": 4, "P;2": 2}
_BANDS = {"R": 0, "G": 1, "B": 2}


def bits(rawmode: str) -> int:
    """Bits a pixel of ``rawmode`` takes in the file."""
    if rawmode in _BITS:
        return _BITS[rawmode]
    if rawmode in _WORDS:
        return np.dtype(_WORDS[rawmode][0]).itemsize * 8
    if rawmode in _PLANES:
        return 8 * _PLANES[rawmode]
    if rawmode in _BYTES:
        return 8 * _BYTES[rawmode]
    if rawmode in _BANDS:
        return 8
    raise ValueError(f"unknown raw mode {rawmode!r}")


def _known(mode: str, rawmode: str) -> bool:
    if rawmode in _WORD_MODES:
        return mode == _WORD_MODES[rawmode]
    if rawmode in _WORDS:
        return mode == ("I" if rawmode.startswith("I") else "F")
    if rawmode in ("1", "1;I", "1;R"):
        return mode == "1"
    if rawmode == "L;4":
        return mode == "L"
    if rawmode in ("P;2", "P;4", "P"):
        return mode == "P"
    if rawmode in ("RGB;L", "RGBX;L", "RGB", "BGR", "RGBX", "BGRX"):
        return mode == "RGB" or (mode == "RGBA" and rawmode == "BGR")
    if rawmode in _BANDS:
        return mode == "RGB"
    if rawmode in ("LA;L", "LA"):
        return mode == "LA"
    if rawmode in ("PA;L", "PA"):
        return mode == "PA"
    return rawmode.split(";")[0] == mode and rawmode in set(_PLANES) | set(
        _BYTES)


def unpack(mode: str, rawmode: str, rows: np.ndarray, w: int) -> np.ndarray:
    """``rows`` (h, >= row bytes) uint8 in ``rawmode`` -> the pixels of a
    ``mode`` picture (for a band rawmode, that band alone: (h, w))."""
    if not _known(mode, rawmode):
        raise ValueError(f"unknown raw mode {rawmode!r} for an image of mode "
                         f"{mode!r}")
    h = rows.shape[0]
    if rawmode in _BITS:
        b = _BITS[rawmode]
        if b == 1:
            bits_ = np.unpackbits(rows, axis=1, bitorder="little" if
                                  rawmode == "1;R" else "big")[:, :w]
            if rawmode == "1;I":
                bits_ = 1 - bits_
            return bits_ * np.uint8(255)
        per = 8 // b
        shifts = np.arange(8 - b, -1, -b, dtype=np.uint8)
        nb = (w + per - 1) // per
        v = (rows[:, :nb, None] >> shifts) & ((1 << b) - 1)
        v = v.reshape(h, -1)[:, :w].astype(np.uint8)
        return v * np.uint8(17) if rawmode == "L;4" else v
    if rawmode in _WORDS:
        src, dst = _WORDS[rawmode]
        n = np.dtype(src).itemsize
        v = np.ascontiguousarray(rows[:, :w * n]).view(src).reshape(h, w)
        if dst is np.int32 and src.endswith("u4"):
            return v.astype(np.uint32).view(np.int32)
        return v.astype(dst)
    if rawmode in _BANDS:
        return np.ascontiguousarray(rows[:, :w])
    if rawmode in _PLANES:
        k = _PLANES[rawmode]
        px = rows[:, :k * w].reshape(h, k, w).transpose(0, 2, 1)
        if rawmode == "RGBX;L":
            px = px[..., :3]
        return np.ascontiguousarray(px)
    k = _BYTES[rawmode]
    px = rows[:, :k * w].reshape(h, w, k) if k > 1 else rows[:, :w]
    if rawmode in ("BGR", "BGRX"):
        px = px[..., 2::-1]
    elif rawmode == "RGBX":
        px = px[..., :3]
    if mode == "RGBA" and rawmode == "BGR":
        px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], -1)
    return np.ascontiguousarray(px)


def row_bytes(w: int, rawmode: str) -> int:
    return (w * bits(rawmode) + 7) // 8


def raw(data: bytes, offset: int, size, mode: str, rawmode: str,
        stride: int = 0, ystep: int = 1) -> np.ndarray:
    """Pillow's ``raw`` tile of ``data`` at ``offset`` (see the module)."""
    w, h = size
    if not _known(mode, rawmode):
        raise ValueError(f"unknown raw mode {rawmode!r} for an image of mode "
                         f"{mode!r}")
    rb = row_bytes(w, rawmode)
    stride = stride or rb
    if stride < rb:
        raise ValueError(f"a row stride of {stride} below the row's {rb} "
                         "bytes")
    need = (h - 1) * stride + rb
    if offset < 0 or len(data) - offset < need:
        raise ValueError(TRUNCATED)
    buf = np.frombuffer(data, np.uint8, need, offset)
    if stride == rb:
        rows = buf.reshape(h, rb)
    else:
        rows = np.lib.stride_tricks.as_strided(buf, (h, rb), (stride, 1))
    if ystep < 0:
        rows = rows[::-1]
    return unpack(mode, rawmode, np.ascontiguousarray(rows), w)


def set_as_raw(data: bytes, size, mode: str, rawmode: str) -> np.ndarray:
    """``PyDecoder.set_as_raw``: the same rows from the start of ``data``;
    too few bytes raise ``not enough image data``."""
    if len(data) < (size[1] - 1) * row_bytes(size[0], rawmode) + row_bytes(
            size[0], rawmode):
        raise ValueError("not enough image data")
    return raw(data, 0, size, mode, rawmode)


def bit_decode(data: bytes, offset: int, size, bits: int) -> np.ndarray:
    """Pillow's ``bit`` decoder as IM's ``L*N image`` types call it
    (``bits`` 2-31, fill 3, no sign, rows padded to bytes, bottom to top):
    each byte enters a bit buffer above the bits it holds, each pixel is
    the buffer's low ``bits`` bits as a float.  At a row's end the count
    of held bits is cleared but not the buffer (Pillow's ``BitDecode``), so
    the next byte is ORed onto what the row left; past 32 held bits the
    buffer is refilled from the last byte alone."""
    w, h = size
    out = np.zeros((h, w), np.float32)
    mask = (1 << bits) - 1
    buf = held = x = 0
    y = h - 1
    for byte in data[offset:]:
        buf |= byte << held
        held += 8
        while held >= bits:
            out[y, x] = buf & mask
            if held > 32:
                buf = byte >> (8 - (held - bits))
            else:
                buf >>= bits
            held -= bits
            x += 1
            if x >= w:
                y -= 1
                if y < 0:
                    return out
                x = held = 0
    raise ValueError(TRUNCATED)
