"""A BLP reader: what Pillow's ``BlpImagePlugin`` gives.

BLP1: compression 0 is JPEG (the header's tables, here ``data/jpeg.py``,
prepended to mip 0's bytes; a CMYK stream read with rawmode ``CMYK``, not
Pillow's inverted ``CMYK;I``), converted to ``RGB`` and stored as if it
were ``BGR`` (its channels swapped); compression 1 with encoding 4 or 5 is
a 256-entry BGRA palette and indices (read on from the palette, whatever
mip 0's offset).  BLP2: encoding 1 is the palette and mip 0's indices;
encoding 2 is DXT1 (with alpha where the alpha depth is not 0), DXT3 or
DXT5, decoded as Pillow's own Python decoders decode them: 5- and 6-bit
values widened by a shift (no bit replication), the interpolations in
integer division, DXT3's 4-bit alpha times 17.  The mode is ``RGBA`` where
the header's alpha field is not 0, else ``RGB``; Pillow then reads its
bytes raw in that mode, so DXT3 and DXT5 (four bytes a pixel) in an
``RGB`` file, and the block rows of a width not a multiple of 4, come out
as Pillow gives them.
"""
from __future__ import annotations

import struct

import numpy as np

from . import jpeg, unpack


def open_blp(data: bytes) -> dict:
    magic = data[:4]
    compression = struct.unpack("<i", data[4:8])[0]
    if magic == b"BLP1":
        alpha = struct.unpack("<I", data[8:12])[0] != 0
        size = struct.unpack("<II", data[12:20])
        encoding = struct.unpack("<i", data[20:24])[0]
        alpha_encoding, offset = None, 28
    else:
        encoding, alpha, alpha_encoding = struct.unpack("<bbb", data[8:11])
        alpha = alpha != 0
        size = struct.unpack("<II", data[12:20])
        offset = 20
    return dict(size=size, mode="RGBA" if alpha else "RGB", magic=magic,
                compression=compression, encoding=encoding,
                alpha_encoding=alpha_encoding, offset=offset)


class _Reader:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        """``ImageFile._safe_read``: ``n`` bytes or ``OSError``."""
        if n <= 0:
            return b""
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        if len(out) < n:
            raise ValueError("Truncated File Read")
        return out


def _palette(r: _Reader) -> np.ndarray:
    """256 BGRA entries, as (256, 4) RGBA."""
    bgra = np.frombuffer(r.read(1024), np.uint8).reshape(256, 4)
    return bgra[:, [2, 1, 0, 3]]


def _indexed(r: _Reader, palette: np.ndarray, alpha: bool,
             length: int) -> bytes:
    idx = np.frombuffer(r.read(length), np.uint8)
    return palette[idx][:, :4 if alpha else 3].tobytes()


def _565(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.int64)
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2,
                     (c & 0x1F) << 3], -1)


def _colours(c0: np.ndarray, c1: np.ndarray, four: bool) -> np.ndarray:
    """(blocks, 4, 3) the block's colours; ``four`` the DXT3/5 rule (every
    block four colours), else DXT1's (three and transparent black where
    ``color0 <= color1``)."""
    p0, p1 = _565(c0), _565(c1)
    hi = (c0 > c1)[:, None] if not four else np.ones((len(c0), 1), bool)
    third = np.where(hi, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    fourth = np.where(hi, (2 * p1 + p0) // 3, 0)
    return np.stack([p0, p1, third, fourth], 1)


def _pick(colours: np.ndarray, code: np.ndarray) -> np.ndarray:
    """(blocks, 16, 3): each pixel's colour by its 2-bit code."""
    sel = (code[:, None].astype(np.int64) >> (2 * np.arange(16))) & 3
    return np.take_along_axis(colours, sel[..., None], 1)


def dxt_rows(body: bytes, n: int, w: int, h: int, alpha: bool) -> bytes:
    """``decode_dxt1`` (``n`` 1), ``decode_dxt3`` (3) or ``decode_dxt5``
    (5) on every row of blocks, joined as ``BLP2Decoder`` joins them."""
    size = 8 if n == 1 else 16
    bw, bh = (w + 3) // 4, (h + 3) // 4
    blocks = np.frombuffer(body, np.uint8, bw * bh * size).reshape(-1, size)
    col = blocks[:, -8:]
    c0 = col[:, 0].astype(np.int64) | (col[:, 1].astype(np.int64) << 8)
    c1 = col[:, 2].astype(np.int64) | (col[:, 3].astype(np.int64) << 8)
    code = np.ascontiguousarray(col[:, 4:8]).view("<u4")[:, 0]
    rgb = _pick(_colours(c0, c1, n != 1), code)
    if n == 1:
        sel = (code[:, None].astype(np.int64) >> (2 * np.arange(16))) & 3
        a = np.where((c0 <= c1)[:, None] & (sel == 3), 0, 255)
    elif n == 3:
        nib = np.stack([blocks[:, :8] & 0xF, blocks[:, :8] >> 4], -1)
        a = nib.reshape(-1, 16).astype(np.int64) * 17
    else:
        a0, a1 = blocks[:, 0].astype(np.int64), blocks[:, 1].astype(np.int64)
        bits = np.zeros(len(blocks), np.int64)
        for k in range(6):
            bits |= blocks[:, 2 + k].astype(np.int64) << (8 * k)
        sel = (bits[:, None] >> (3 * np.arange(16))) & 7
        a0c, a1c = a0[:, None], a1[:, None]
        interp8 = ((8 - sel) * a0c + (sel - 1) * a1c) // 7
        interp6 = ((6 - sel) * a0c + (sel - 1) * a1c) // 5
        a = np.where(sel == 0, a0c, np.where(sel == 1, a1c, np.where(
            a0c > a1c, interp8, np.where(sel == 6, 0, np.where(
                sel == 7, 255, interp6)))))
    px = np.concatenate([rgb, a[..., None]], -1) if (n != 1 or alpha) \
        else rgb
    c = px.shape[-1]
    # (bh, bw, 4 rows, 4 columns, c) -> rows of bw * 4 pixels
    return px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).astype(
        np.uint8).tobytes()


def load_blp(data: bytes, head: dict):
    (w, h), mode = head["size"], head["mode"]
    alpha = mode == "RGBA"
    r = _Reader(data, head["offset"])
    offsets = struct.unpack("<16I", r.read(64))
    lengths = struct.unpack("<16I", r.read(64))
    comp, enc = head["compression"], head["encoding"]
    if head["magic"] == b"BLP1":
        if comp == 0:
            return _blp1_jpeg(data, r, offsets, lengths, w, h, mode)
        if comp != 1 or enc not in (4, 5):
            raise ValueError(f"Unsupported BLP encoding {enc!r}")
        body = _indexed(r, _palette(r), alpha, lengths[0])
    else:
        palette = _palette(r)
        r.pos = offsets[0]
        if comp != 1:
            raise ValueError(f"Unknown BLP compression {comp!r}")
        if enc == 1:
            body = _indexed(r, palette, alpha, lengths[0])
        elif enc == 2:
            n = {0: 1, 1: 3, 7: 5}.get(head["alpha_encoding"])
            if n is None:
                raise ValueError("Unsupported alpha encoding "
                                 f"{head['alpha_encoding']!r}")
            size = 8 if n == 1 else 16
            body = r.read((w + 3) // 4 * size * ((h + 3) // 4))
            body = dxt_rows(body, n, w, h, alpha)
        else:
            raise ValueError(f"Unknown BLP encoding {enc!r}")
    return unpack.set_as_raw(body, (w, h), mode, mode), mode, None, None


def _blp1_jpeg(data, r, offsets, lengths, w, h, mode):
    (header_size,) = struct.unpack("<I", r.read(4))
    tables = r.read(header_size)
    r.read(offsets[0] - r.pos)
    stream = tables + r.read(lengths[0])
    if stream[:3] != b"\xff\xd8\xff":  # JpegImageFile's _accept
        raise ValueError("not a JPEG file")
    try:
        px, jmode = jpeg.decode(stream)
    except jpeg._Unsupported as e:
        raise ValueError(f"a BLP1 JPEG: {e}") from None
    if jmode == "CMYK":
        from .image import _cmyk_to_rgb

        px = _cmyk_to_rgb(px)
    elif jmode == "L":
        px = np.repeat(px[..., None], 3, -1)
    body = np.ascontiguousarray(px).tobytes()
    return unpack.set_as_raw(body, (w, h), mode, "BGR"), mode, None, None
