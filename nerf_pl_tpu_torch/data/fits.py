"""A FITS reader: what Pillow's ``FitsImagePlugin`` gives.

The 80-byte header records of the primary unit (``SIMPLE = T`` first),
and of the extensions after it, up to the first unit that holds an image:
``NAXIS`` 1 (a width of 1) or more, ``BITPIX`` 8, 16, 32, -32 or -64 to
``L``, ``I;16``, ``I``, ``F`` and ``F``, the pixels raw after the header's
2880-byte blocks, rows bottom to top, in Pillow's rawmode of the mode
(``I;16`` little-endian, ``F`` four bytes a pixel, whatever the file's
order and width).  A ``BINTABLE`` extension with ``ZIMAGE = T`` and
``ZCMPTYPE = 'GZIP_1'`` holds a gzip stream after the table
(``NAXIS1 * NAXIS2 * BITPIX / 8`` bytes): its ``Z``-prefixed keys give
the image, decompressed with the standard library's ``gzip``, each pixel
the last ``min(ZBITPIX / 8, 4)`` bytes of a 4-byte word (a negative
``ZBITPIX`` takes none: not enough image data), rows bottom to top.
"""
from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from . import unpack

_MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}


def _size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse(headers: dict):
    """``_parse_headers``: (decoder, offset, size, mode, bits) or None."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'"
            and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        w, h = _size(headers, prefix) or (0, 0)
        offset = w * h * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix)
    if not size:
        return None
    bits = int(headers[prefix + b"BITPIX"])
    return decoder, offset, size, _MODES.get(bits, ""), bits


def open_fits(data: bytes) -> dict:
    """``FitsImageFile._open``: the header, or ``SyntaxError`` (KeyError)
    where ``Image.open`` moves on."""
    headers, in_progress, parsed, pos = {}, False, None, 0
    while True:
        record = data[pos:pos + 80]
        pos += 80
        if not record:
            raise OSError("Truncated FITS file")
        keyword = record[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break  # the data unit
        elif keyword == b"END":
            pos = math.ceil(min(pos, len(data)) / 2880) * 2880
            if not parsed:
                parsed = _parse(headers)
            in_progress = False
            continue
        if parsed:
            continue
        value = record[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE")
                            or value != b"T"):
            raise SyntaxError("Not a FITS file")
        headers[keyword] = value
    if not parsed:
        raise ValueError("No image data")
    decoder, offset, size, mode, bits = parsed
    return dict(size=size, mode=mode, decoder=decoder, bits=bits,
                offset=offset + min(pos, len(data)) - 80)


def load_fits(data: bytes, head: dict):
    (w, h), mode = head["size"], head["mode"]
    if head["decoder"] == "raw":
        px = unpack.raw(data, head["offset"], (w, h), mode, mode, ystep=-1)
        return px, mode, None, None
    try:
        value = gzip.decompress(data[head["offset"]:])
    except (OSError, EOFError, zlib.error) as e:
        raise ValueError(f"fits_gzip: {e}") from None
    nb = min(head["bits"] // 8, 4)
    if nb <= 0:
        raise ValueError("not enough image data")
    if len(value) >= 4 * w * h:
        words = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)
        body = words[::-1, :, 4 - nb:].tobytes()
    else:  # a short stream: each word's slice as Python slices it
        rows = [b"".join(value[4 * (y * w + x) + 4 - nb:4 * (y * w + x) + 4]
                         for x in range(w)) for y in range(h)]
        body = b"".join(rows[::-1])
    return unpack.set_as_raw(body, (w, h), mode, mode), mode, None, None
