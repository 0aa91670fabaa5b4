"""An IPTC/NAA reader: what Pillow's ``IptcImagePlugin`` gives.

Fields of five bytes (0x1C, record, dataset, a big-endian size or, past
0x8000, the size's own length) up to the first image field (8, 10) or
five zero bytes; (3, 60) gives the layers and whether it is one band of
them: one layer and no component is ``L``, three or four layers with a
component ``RGB`` or ``CMYK``, with the band of (3, 65) (less one; 0
without it).  (3, 20) and (3, 30) give the size, (3, 120) the compression
(1 ``raw``, 5 ``jpeg``; any other raises).  The image fields' bytes are
opened as a file of their own (``raw`` behind a ``P5`` header, as Pillow
writes it) and, for a band, put in that band of an image whose other
bands are 0.  Pillow's image keeps the header's size with the image
data's core image (``self.im = im.im``): where the two differ, its array
is the core's bytes from the start, as many as the header's size takes
(the top rows where the widths agree), and ``convert`` and ``resize`` see
the core (``Picture.core``).  Where the header's size takes more bytes
than the core holds, Pillow's array reads past them: that raises here.
"""
from __future__ import annotations

import io
import struct

import numpy as np

_COMPRESSION = {1: "raw", 5: "jpeg"}
_BANDS = {"L": 1, "RGB": 3, "CMYK": 4}


def _i(c: bytes) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def _field(fp: io.BytesIO):
    s = fp.read(5)
    if not s.strip(b"\0"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise ValueError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = _i(fp.read(size - 128))
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size


def open_iptc(data: bytes) -> dict:
    """``IptcImageFile._open``: the fields, or ``SyntaxError`` (KeyError,
    IndexError, TypeError) where ``Image.open`` moves on."""
    fp, info = io.BytesIO(data), {}
    while True:
        offset = fp.tell()
        tag, size = _field(fp)
        if not tag or tag == (8, 10):
            break
        tagdata = fp.read(size) if size else None
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(tagdata)
            else:
                info[tag] = [info[tag], tagdata]
        else:
            info[tag] = tagdata
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    size = _i(info[(3, 20)]), _i(info[(3, 30)])
    try:
        compression = _COMPRESSION[_i(info[(3, 120)])]
    except KeyError:
        raise ValueError("Unknown IPTC image compression") from None
    return dict(size=size, mode=mode, band=band, compression=compression,
                offset=offset if tag == (8, 10) else None)


def load_iptc(data: bytes, head: dict):
    from .image import open_format

    if head["offset"] is None:
        raise ValueError("cannot load this image (no image data field)")
    fp = io.BytesIO(data)
    fp.seek(head["offset"])
    out = io.BytesIO()
    if head["compression"] == "raw":
        out.write(b"P5\n%d %d\n255\n" % head["size"])
    try:
        while True:
            tag, size = _field(fp)
            if tag != (8, 10):
                break
            out.write(fp.read(size))
    except (SyntaxError, IndexError, struct.error) as e:  # a cut field
        raise ValueError(f"a broken field after the image data: {e}") from None
    from .image import Picture

    _, load = open_format(out.getvalue(), head["path"])
    pic = Picture(*load()[:4])
    px, mode, palette, transparency = (pic.pixels, pic.mode, pic.palette,
                                       pic.transparency)
    band = head["band"]
    if band is None:
        if mode != head["mode"]:
            raise ValueError(f"an IPTC image of mode {head['mode']} holding "
                             f"a {mode} image")
    else:
        if mode != "L":
            raise ValueError("mode mismatch")
        bands = [np.zeros_like(px)] * _BANDS[head["mode"]]
        if not -len(bands) <= band < len(bands):
            raise ValueError(f"band {band} of a {head['mode']} image")
        bands[band] = px
        px, mode, palette, transparency = (np.stack(bands, -1), head["mode"],
                                           None, None)
    w, h = head["size"]
    if (w, h) == (px.shape[1], px.shape[0]):
        return px, mode, palette, transparency
    # the header's size over the core image's bytes
    per = px[0, 0].size
    if w * h * per > px.size:
        raise ValueError(f"the header's {w}x{h} pixels past the image data's "
                         f"{px.shape[1]}x{px.shape[0]} (Pillow's array reads "
                         "memory past its image)")
    shown = px.reshape(-1)[:w * h * per].reshape((h, w) + px.shape[2:])
    return shown, mode, palette, transparency, None, 0, px
