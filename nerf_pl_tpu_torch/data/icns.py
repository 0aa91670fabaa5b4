"""An ICNS reader: the icon Pillow's ``IcnsImagePlugin`` picks, as it gives
it.

The ``icns`` header and its blocks (type, size) up to the file's stated
size; ``SIZES`` lists the icon each type belongs to, and Pillow takes the
largest (``bestsize``: the greatest (width, height, scale)).  That icon's
types are all read: a PNG payload (``data/png.py``) in its own mode (the
picture takes that mode, not the PNG's transparency), a JPEG 2000 payload
(``data/jpeg2000.py``) converted to ``RGBA``, or the ``is32``, ``il32``,
``ih32`` and ``it32`` channels (``it32`` after four zero bytes): three
planes raw where the block is exactly their size, else three run-length
channels (``read_32``; the runs in C++, ``data/rle.py``; ``rgb_plain`` is
the same stage in Python) read on past the block's end, with the mask of
``s8mk``, ``l8mk``, ``h8mk`` or ``t8mk`` as alpha (``RGBA``; ``RGB``
without one).  A PNG or JPEG 2000 payload wins over the channels; its
size must divide the icon's as Pillow's size setter requires.
"""
from __future__ import annotations

import struct

import numpy as np

from . import jpeg2000, png, rle

_PNG = b"\x89PNG\r\n\x1a\n"
SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",),
    (256, 256, 2): (b"ic14",), (256, 256, 1): (b"ic08",),
    (128, 128, 2): (b"ic13",), (128, 128, 1): (b"ic07", b"it32", b"t8mk"),
    (64, 64, 1): (b"icp6",), (32, 32, 2): (b"ic12",),
    (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"), (16, 16, 2): (b"ic11",),
    (16, 16, 1): (b"icp4", b"is32", b"s8mk"),
}
_CHANNELS = (b"it32", b"ih32", b"il32", b"is32")
_MASKS = (b"t8mk", b"h8mk", b"l8mk", b"s8mk")


def open_icns(data: bytes) -> dict:
    """``IcnsFile`` and ``IcnsImageFile._open``: the blocks and the size
    Pillow picks, or ``SyntaxError`` (``struct.error``) where
    ``Image.open`` moves on."""
    sig, filesize = struct.unpack(">4sI", data[:8])
    if sig != b"icns":
        raise SyntaxError("not an icns file")
    blocks, i = {}, 8
    while i < filesize:
        sig, blocksize = struct.unpack(">4sI", data[i:i + 8])
        if blocksize <= 0:
            raise SyntaxError("invalid block header")
        i += 8
        blocks[sig] = (i, blocksize - 8)
        i += blocksize - 8
    sizes = [s for s, types in SIZES.items() if any(t in blocks for t in
                                                     types)]
    if not sizes:
        raise SyntaxError("No 32bit icon resources found")
    best = max(sizes)
    return dict(size=(best[0] * best[2], best[1] * best[2]), mode="RGBA",
                blocks=blocks, best=best, sizes=sizes)


def rgb_plain(data: bytes, npix: int) -> np.ndarray:
    """``read_32``'s three run-length channels: (3, npix) bytes."""
    out, pos = [], 0
    for _ in range(3):
        chunks, left, short = [], npix, False
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                k = b - 125
                v = data[pos:pos + 1]
                pos += len(v)
                chunks.append(v * k)
                short |= not v
            else:
                k = b + 1
                v = data[pos:pos + k]
                pos += len(v)
                chunks.append(v)
                short |= len(v) < k
            left -= k
        if left != 0:
            raise ValueError(rle.ICNS_ERRORS[-2])
        band = b"".join(chunks)
        if len(band) < npix:
            raise ValueError(rle.ICNS_ERRORS[-1])
        out.append(np.frombuffer(band, np.uint8))
    return np.stack(out)


def _payload(data: bytes, start: int, length: int):
    """``read_png_or_jpeg2000``: (pixels, mode, palette)."""
    from .image import Picture, convert

    sig = data[start:start + 12]
    if sig.startswith(_PNG):
        px, mode, palette, _ = png.decode_png(data[start:], "ICNS PNG")
        return px, mode, palette
    if sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) or \
            sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
        stream = data[start:start + max(length, 0)]
        try:
            head = jpeg2000.open_jpeg2000(stream)
        except (SyntaxError, struct.error, AssertionError) as e:
            raise ValueError(f"an ICNS JPEG 2000 payload: {e}") from None
        pic = Picture(*jpeg2000.load_jpeg2000(stream, head))
        if pic.mode == "RGBA":
            return pic.pixels, "RGBA", None
        return convert(pic, "RGBA"), "RGBA", None
    raise ValueError("Unsupported icon subimage format")


def load_icns(data: bytes, head: dict, plain: bool = False):
    w, h, scale = head["best"]
    pw, ph = w * scale, h * scale
    npix = pw * ph
    found = {}
    for code in SIZES[head["best"]]:
        if code not in head["blocks"]:
            continue
        start, length = head["blocks"][code]
        if code in _MASKS:
            band = data[start:start + npix]
            if len(band) < npix:
                raise ValueError("not enough image data")
            found["A"] = np.frombuffer(band, np.uint8).reshape(ph, pw)
        elif code in _CHANNELS:
            if code == b"it32":
                if data[start:start + 4] != b"\0\0\0\0":
                    raise ValueError("Unknown signature, expecting "
                                     "0x00000000")
                start, length = start + 4, length - 4
            if length == npix * 3:
                rgb = np.frombuffer(data[start:start + length], np.uint8)
                if len(rgb) < 3 * npix:
                    raise ValueError("not enough image data")
                found["RGB"] = rgb.reshape(ph, pw, 3)
            else:
                planes = (rgb_plain if plain else rle.icns_rgb)(
                    data[start:], npix)
                found["RGB"] = np.ascontiguousarray(
                    planes.reshape(3, ph, pw).transpose(1, 2, 0))
        else:
            found["RGBA"] = _payload(data, start, length)
    opened = ("RGBA", (pw, ph))
    if "RGBA" in found:
        px, mode, palette = found["RGBA"]
        _check_size(head["sizes"], (px.shape[1], px.shape[0]))
        return px, mode, palette, None, opened
    if "RGB" not in found:
        raise ValueError("an ICNS icon with a mask and no channels")
    if "A" in found:
        return np.concatenate([found["RGB"], found["A"][..., None]], -1), \
            "RGBA", None, None, opened
    return found["RGB"], "RGB", None, None, opened


def _check_size(sizes, value) -> None:
    """``IcnsImageFile.size``'s setter: a size that one of the icons'
    sizes is a whole multiple of."""
    for w, h, s in sizes:
        if value[0] == 0 or value[1] == 0:
            raise ValueError("an ICNS payload of size 0")
        if (h * s) / value[1] == (w * s) // value[0]:
            return
    raise ValueError("This is not one of the allowed sizes of this image")
