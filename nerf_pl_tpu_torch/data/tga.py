"""A TGA reader: what Pillow's ``TgaImagePlugin`` gives.

Image types 1, 2 and 3 and their run-length forms 9, 10 and 11 at the
depths of the plugin's ``MODES``: colour-mapped 8-bit ``P`` (the map's
entries behind its first-entry offset of black; 16-bit entries as
``BGRA;15Z``, whose alphas Pillow's ``P`` to ``RGBA`` reads, kept here as
``transparency`` bytes; 24-bit entries as ``BGR``), 1-bit ``1``, 8-bit
``L``, 16-bit ``LA`` (with a colour map, Pillow's core image becomes ``P``
or ``PA`` under the ``L`` or ``LA`` mode: the picture keeps the map as its
palette, which ``data/image.py`` converts through and will not resize, as
Pillow), and true colour 16-bit (``BGRA;15Z``: 5-5-5 scaled by
255/31, alpha 0 where the top bit is set), 24-bit ``RGB`` and 32-bit
``RGBA``.  The image-ID field is skipped.  Rows run bottom-up unless the
descriptor's ``0x20`` is set; ``0x10`` flips each row, as Pillow's
``_flip_horizontally``.  A run packet that reaches past its row raises, as
Pillow's decoder does; a raw packet runs on into the next row.  What the
plugin refuses (a colour map of 15 or 32 bits, a type and depth outside
``MODES``, a run-length 1-bit image) raises ``ValueError``.

The run-length stage runs in C++ (``data/rle.py``); ``rle_plain`` is the
same stage in Python.
"""
from __future__ import annotations

import struct

import numpy as np

from . import rle

MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
         (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}


def open_tga(data: bytes) -> dict:
    """``TgaImageFile._open``: the header, or ``SyntaxError`` (IndexError,
    ``struct.error``) where ``Image.open`` tries the next format."""
    s = data[:18]
    id_len, cmtype, itype = s[0], s[1], s[2]
    depth, flags = s[16], s[17]
    w, h = struct.unpack_from("<HH", s, 12)
    if cmtype not in (0, 1) or w <= 0 or h <= 0 or depth not in (
            1, 8, 16, 24, 32):
        raise SyntaxError("not a TGA file")
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if cmtype else "L"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise SyntaxError("unknown TGA mode")
    pos = min(18 + id_len, len(data))
    head = dict(size=(w, h), mode=mode, depth=depth, rle=bool(itype & 8),
                rawmode=MODES.get((itype & 7, depth)),
                top_down=bool(flags & 0x20), flip=bool(flags & 0x10),
                mapdepth=None, cmap=b"")
    if cmtype:
        start, count, mapdepth = struct.unpack_from("<HHB", s, 3)
        size = {16: 2, 24: 3, 32: 4}.get(mapdepth)
        if size is None:
            raise SyntaxError("unknown TGA map depth")
        body = data[pos:pos + size * count]
        pos += len(body)
        head.update(mapdepth=mapdepth, cmap=bytes(size * start) + body)
    head["pos"] = pos
    return head


def rle_plain(data: bytes, w: int, h: int, depth: int) -> np.ndarray:
    """Pillow's ``TgaRleDecode``: packets of ``depth``-byte pixels into
    (h, w * depth) bytes, rows in file order."""
    row, total = w * depth, w * h * depth
    out = bytearray()
    pos, n_in = 0, len(data)
    while len(out) < total:
        if pos >= n_in:
            raise ValueError(rle.ERRORS[-1])
        c = data[pos]
        n = depth * ((c & 0x7F) + 1)
        if c & 0x80:
            if pos + 1 + depth > n_in:
                raise ValueError(rle.ERRORS[-1])
            if len(out) % row + n > row:
                raise ValueError(rle.ERRORS[-2])
            out += data[pos + 1:pos + 1 + depth] * ((c & 0x7F) + 1)
            pos += 1 + depth
        else:
            if pos + 1 + n > n_in:
                raise ValueError(rle.ERRORS[-1])
            out += data[pos + 1:pos + 1 + n]
            pos += 1 + n
    return np.frombuffer(bytes(out[:total]), np.uint8).reshape(h, row)


def _bgra15z(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int32)
    rgb = [((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)]
    return np.stack(rgb + [np.where(v & 0x8000, 0, 255)], -1).astype(np.uint8)


def _unpack(rawmode: str, rows: np.ndarray, w: int) -> np.ndarray:
    h = rows.shape[0]
    if rawmode == "1":
        return np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
    if rawmode in ("P", "L"):
        return rows[:, :w]
    if rawmode == "LA":
        return rows[:, :2 * w].reshape(h, w, 2)
    if rawmode == "BGRA;15Z":
        return _bgra15z(rows[:, :2 * w].copy().view("<u2"))
    c = 3 if rawmode == "BGR" else 4
    px = rows[:, :c * w].reshape(h, w, c)
    return np.concatenate([px[..., 2::-1], px[..., 3:]], -1)


def load_tga(data: bytes, head: dict, plain: bool = False):
    """``(pixels, mode, palette, transparency)`` of an opened header."""
    (w, h), mode, rawmode = head["size"], head["mode"], head["rawmode"]
    if rawmode is None:
        raise ValueError("cannot load this image (a TGA type and depth "
                         "Pillow has no raw mode for)")
    if mode == "L" and rawmode == "P":
        raise ValueError("unknown raw mode for given image mode (a "
                         "colour-mapped TGA without a colour map)")
    if head["mapdepth"] == 32:
        raise ValueError("unrecognized raw mode (a 32-bit TGA colour map)")
    if head["mapdepth"] and mode not in ("P", "L", "LA"):
        raise ValueError(f"unrecognized image mode (a TGA colour map on "
                         f"{mode} pixels)")
    depth, body = head["depth"], data[head["pos"]:]
    if head["rle"]:
        if depth == 1:
            raise ValueError("image file is truncated (a run-length 1-bit "
                             "TGA, which Pillow does not decode)")
        rows = (rle_plain if plain else rle.tga_rle)(body, w, h, depth // 8)
    else:
        stride = (w + 7) // 8 if depth == 1 else w * depth // 8
        if len(body) < stride * h:
            raise ValueError("image file is truncated")
        rows = np.frombuffer(body[:stride * h], np.uint8).reshape(h, stride)
    px = _unpack(rawmode, rows, w)
    if not head["top_down"]:
        px = px[::-1]
    if head["flip"]:
        px = px[:, ::-1]
    palette = transparency = None
    if head["mapdepth"]:  # P, or L and LA that Pillow's core makes P and PA
        cmap = head["cmap"]
        if head["mapdepth"] == 16:
            ent = _bgra15z(np.frombuffer(cmap[:len(cmap) // 2 * 2], "<u2"))
            palette, transparency = ent[:, :3].copy(), ent[:, 3].tobytes()
        else:
            palette = np.frombuffer(cmap[:len(cmap) // 3 * 3],
                                    np.uint8).reshape(-1, 3)[:, ::-1].copy()
    return np.ascontiguousarray(px), mode, palette, transparency
