"""A TIFF reader: the first image of a file, as Pillow's ``TiffImagePlugin``
opens it.

It reads the first IFD of a classic or BigTIFF file in either byte order,
from strips or tiles (edge tiles cropped), with PlanarConfiguration 1 or 2,
and finds Pillow's mode and raw mode by the plugin's own key (byte order,
photometric, sample format, fill order, bits per sample, extra samples;
``_OPEN_INFO``, a copy of ``TiffImagePlugin.OPEN_INFO``).  Compression 1
(none), 2, 3 and 4 (CCITT fax, ``data/ccitt.py``), 5 (LZW, with libtiff's
old-style codes), 8 and 32946 (Deflate, ``zlib``), 32773 (PackBits), 34925
(LZMA, ``lzma``), 50000 (zstd, ``data/zstd.py``) and 7 (JPEG, through
``data/jpeg.py`` with the ``JPEGTables`` spliced in; Pillow has libtiff
return RGB, and libtiff checks the sampling factors); predictors 2
(8/16/32-bit, in the file's byte order) and 3 (floating point, float
samples only).  LZW and PackBits are C++ stages (``csrc/tiff_decode.cpp``,
built with g++ at first use through ``data/native.py``), as are the fax and
zstd decoders.  Uncompressed YCbCr is read as Pillow's own raw decoder reads
it (``_raw_ycbcr``); YCbCr compressed otherwise as libtiff's RGBA interface
gives it to Pillow (``_rgba_ycbcr``: ``TIFFYCbCrToRGBInit``'s tables and the
``putcontig8bitYCbCr`` routines, the C++ stage ``tiff_ycbcr``).  Where
Pillow hands a file to libtiff, libtiff's own directory checks apply
(``_libtiff_refuses``).

After the decode, the orientation is applied as Pillow's ``load_end`` does
(``ImageOps.exif_transpose``): tag 274, else the XMP packet's
``tiff:Orientation``, in the picture's own mode.

The samples become the mode's pixels as Pillow's unpackers make them:
min-is-white inverted, 2- and 4-bit gray scaled to 8 bits, 16-bit RGB(A)
and CMYK read as their high bytes, associated alpha unpremultiplied
(``unpackRGBa``: ``c * 255 / a`` truncated, all zero where ``a`` is 0),
palettes from ``ColorMap`` (each entry's high byte), ``I;16``/``I;16B``
as uint16 values, ``I`` and ``F`` as int32 and float32.  Where libtiff
decodes a compressed file it returns native-order samples, and Pillow
reads ``I;16BS``, ``I;32BS`` and ``F;32BF`` from them as big-endian: so
does this reader.  Anything else raises, naming the file.
"""
from __future__ import annotations

import ctypes
import lzma
import re
import struct
import threading
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from . import ccitt, jpeg, native, unpack, zstd

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tiff_decode.cpp"

# (photometric, sample format, bits, extra samples) -> (mode, raw mode), in
# both byte orders and fill order 1 unless listed under _ONE_ORDER
_OPEN_INFO = {
    (0, (1,), (1,), ()): ("1", "1;I"),
    (1, (1,), (1,), ()): ("1", "1"),
    (0, (1,), (2,), ()): ("L", "L;2I"),
    (1, (1,), (2,), ()): ("L", "L;2"),
    (0, (1,), (4,), ()): ("L", "L;4I"),
    (1, (1,), (4,), ()): ("L", "L;4"),
    (0, (1,), (8,), ()): ("L", "L;I"),
    (1, (1,), (8,), ()): ("L", "L"),
    (1, (2,), (8,), ()): ("L", "L"),
    (1, (1,), (8, 8), (2,)): ("LA", "LA"),
    (2, (1,), (8, 8, 8), ()): ("RGB", "RGB"),
    (2, (1,), (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, (1,), (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (2, (1,), (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (2, (1,), (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, (1,), (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (2, (1,), (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, (1,), (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, (1,), (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (2, (1,), (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (2, (1,), (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (2, (1,), (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (2, (1,), (16, 16, 16), ()): ("RGB", "RGB;16"),
    (2, (1,), (16, 16, 16, 16), ()): ("RGBA", "RGBA;16"),
    (2, (1,), (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16"),
    (2, (1,), (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16"),
    (2, (1,), (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16"),
    (3, (1,), (1,), ()): ("P", "P;1"),
    (3, (1,), (2,), ()): ("P", "P;2"),
    (3, (1,), (4,), ()): ("P", "P;4"),
    (3, (1,), (8,), ()): ("P", "P"),
    (3, (1,), (8, 8), (0,)): ("P", "PX"),
    (3, (1,), (8, 8), (2,)): ("PA", "PA"),
    (5, (1,), (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (5, (1,), (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, (1,), (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
    (5, (1,), (16, 16, 16, 16), ()): ("CMYK", "CMYK;16"),
    (6, (1,), (8,), ()): ("L", "L"),
    (6, (1,), (8, 8, 8), ()): ("RGB", "RGBX"),
    (8, (1,), (8, 8, 8), ()): ("LAB", "LAB"),
}
# keys of one byte order: (order, photometric, format, bits) -> mode, raw
_ONE_ORDER = {
    ("II", 1, (1,), (12,)): ("I;16", "I;12"),
    ("II", 0, (1,), (16,)): ("I;16", "I;16"),
    ("II", 1, (1,), (16,)): ("I;16", "I;16"),
    ("MM", 1, (1,), (16,)): ("I;16B", "I;16B"),
    ("II", 1, (2,), (16,)): ("I", "I;16S"),
    ("MM", 1, (2,), (16,)): ("I", "I;16BS"),
    ("II", 0, (3,), (32,)): ("F", "F;32F"),
    ("MM", 0, (3,), (32,)): ("F", "F;32BF"),
    ("II", 1, (1,), (32,)): ("I", "I;32N"),
    ("II", 1, (2,), (32,)): ("I", "I;32S"),
    ("MM", 1, (2,), (32,)): ("I", "I;32BS"),
    ("II", 1, (3,), (32,)): ("F", "F;32F"),
    ("MM", 1, (3,), (32,)): ("F", "F;32BF"),
}
# fill order 2 has a key for these (photometric, bits) only
_FILL2 = {(0, (1,)), (1, (1,)), (0, (2,)), (1, (2,)), (0, (4,)), (1, (4,)),
          (0, (8,)), (1, (8,)), (2, (8, 8, 8)), (3, (1,)), (3, (2,)),
          (3, (4,)), (3, (8,))}
_FILL2_ONE = {("II", 1, (16,))}
_MAX_SPP = 6
# none, CCITT RLE, CCITT T.4, CCITT T.6, LZW, JPEG, Deflate, Adobe Deflate,
# PackBits, LZMA, zstd
_COMPRESSIONS = frozenset((1, 2, 3, 4, 5, 7, 8, 32946, 32773, 34925, 50000))
_FAX = (2, 3, 4)
# compressions Pillow 12.1's libtiff 4.7 does not decode either
_UNREAD = {6: "old-style JPEG", 32809: "ThunderScan", 34676: "SGILog",
           34677: "SGILog24", 50001: "WebP"}
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}
_BOMB_PIXELS = 2 * 178956970  # Image.MAX_IMAGE_PIXELS, twice
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)

_lock = threading.Lock()
_lib = None


def _native():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SOURCE)))
            for fn in (lib.tiff_lzw, lib.tiff_packbits):
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
            lib.tiff_ycbcr.restype = ctypes.c_int64
            lib.tiff_ycbcr.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            lib.psd_packbits.restype = ctypes.c_int64  # data/psd.py's rows
            lib.psd_packbits.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64]
            _lib = lib
        return _lib


class _Unsupported(ValueError):
    pass


def _ifd(data: bytes, order: str, big: bool):
    """The first IFD's tags: ``{tag: tuple of values}`` (bytes for
    UNDEFINED and ASCII), as Pillow's ``ImageFileDirectory_v2.load`` reads
    them: an entry the file cuts, or a tag whose data runs past the file,
    ends the IFD with the tags before it; a tag of no data is skipped.
    Where it ends so, ``tags["libtiff"]`` adds the inline scalars of the
    entries after, which libtiff reads on to (the predictor it decodes
    with)."""
    e = "<" if order == "II" else ">"
    if big:
        off = struct.unpack(e + "Q", data[8:16])[0]
        n = struct.unpack(e + "Q", data[off:off + 8])[0]
        pos, size, inline = off + 8, 20, 8
    else:
        off = struct.unpack(e + "I", data[4:8])[0]
        n = struct.unpack(e + "H", data[off:off + 2])[0]
        pos, size, inline = off + 2, 12, 4
    entries = []  # (tag, type, count, offset of its data or None)
    tags = {"entries": entries}
    for i in range(n):
        ent = data[pos + i * size:pos + (i + 1) * size]
        if len(ent) < size:  # Pillow keeps the tags before a cut entry
            break
        tag, typ = struct.unpack(e + "HH", ent[:4])
        count = struct.unpack(e + ("Q" if big else "I"), ent[4:4 + inline])[0]
        if typ not in _TYPES:
            entries.append((tag, typ, count, None))
            continue
        fmt = _TYPES[typ]
        nbytes = struct.calcsize(e + fmt) * count
        entries.append((tag, typ, count, None if nbytes <= inline else
                        struct.unpack(e + ("Q" if big else "I"),
                                      ent[4 + inline:4 + 2 * inline])[0]))
        if nbytes == 0:  # no data: Pillow skips the tag
            continue
        if nbytes <= inline:
            raw = ent[4 + inline:4 + inline + nbytes]
        else:
            at = struct.unpack(e + ("Q" if big else "I"),
                               ent[4 + inline:4 + 2 * inline])[0]
            raw = data[at:at + nbytes]
            if len(raw) < nbytes:  # Pillow's _safe_read fails: its IFD
                # ends there, with the tags before; libtiff reads on
                tags["libtiff"] = full = dict(tags)
                for k in range(i + 1, n):
                    ent = data[pos + k * size:pos + (k + 1) * size]
                    if len(ent) < size:
                        break
                    tag, typ = struct.unpack(e + "HH", ent[:4])
                    count = struct.unpack(e + ("Q" if big else "I"),
                                          ent[4:4 + inline])[0]
                    if typ in (3, 4) and count == 1:  # inline scalars
                        full[tag] = struct.unpack(
                            e + _TYPES[typ], ent[4 + inline:4 + inline +
                                                 (2 if typ == 3 else 4)])
                break
        if typ in (2, 7):
            tags[tag] = bytes(raw)
        else:
            vals = struct.unpack(e + fmt * count, raw)
            if typ in (5, 10):
                tags[(tag, "pairs")] = vals  # as libtiff divides them
                vals = tuple(vals[k] / vals[k + 1] if vals[k + 1] else 0.0
                             for k in range(0, len(vals), 2))
            tags[tag] = vals
    return tags


# the tags libtiff's TIFFReadDirectory must fetch (TIFFFetchNormalTag, its
# failure failing the directory): one unsigned value each, ExtraSamples an
# array; the integer types it converts from (the signed ones range-checked)
_LIBTIFF_SCALARS = (256, 257, 278, 284, 322, 323, 32997, 32998)
_INTEGER_TYPES = (1, 3, 4, 6, 8, 9, 16, 17)
# the strip and tile offsets and byte counts (TIFFFetchStripThing)
_LIBTIFF_STRILES = (273, 279, 324, 325)


def _libtiff_refuses(data: bytes, order: str, tags: dict):
    """What makes libtiff fail a file that Pillow's own parse took, for
    the files Pillow hands to libtiff (any compression but none): a tag it
    must fetch of another type or count, or negative; strip or tile
    offsets or byte counts of another type, or whose first values (as many
    as the strips or tiles) lie past the file (libtiff reads the whole IFD,
    where Pillow's stops at the first tag whose data runs past it); a
    PlanarConfiguration other than 1 or 2; a strip or tile whose bytes run
    past the file (``TIFFFillStrip``'s read error).  Raises
    ``ValueError``."""
    w, h = tags[256][0], tags[257][0]
    planes = tags.get(277, (1,))[0] if tags.get(284, (1,))[0] == 2 else 1
    if 322 in tags:
        n = -(-w // max(tags[322][0], 1)) * -(-h // max(tags.get(
            323, (1,))[0], 1)) * planes
    else:
        n = -(-h // max(min(tags.get(278, (2 ** 32 - 1,))[0], h), 1)) * planes
    striles = {}  # libtiff's own offsets and byte counts
    for tag, typ, count, at in tags["entries"]:
        if tag in _LIBTIFF_SCALARS and (typ not in _INTEGER_TYPES
                                        or count != 1):
            raise ValueError(f"tag {tag} of type {typ} and count {count} "
                             "(libtiff cannot fetch it)")
        if tag in _LIBTIFF_STRILES:
            if typ not in _INTEGER_TYPES:
                raise ValueError(f"tag {tag} of type {typ} (libtiff cannot "
                                 "fetch it)")
            striles[tag] = tags.get(tag)
            if at is not None:  # TIFFReadDirEntryLong8ArrayWithLimit: as
                # many values as there are strips or tiles
                fmt = ("<" if order == "II" else ">") + _TYPES[typ] * min(
                    count, n)
                if at + struct.calcsize(fmt) > len(data):
                    raise ValueError(f"tag {tag}'s values past the file's "
                                     "end (libtiff cannot fetch them)")
                striles[tag] = struct.unpack_from(fmt, data, at)
        if tag == 338 and typ not in _INTEGER_TYPES:
            raise ValueError(f"ExtraSamples of type {typ} (libtiff cannot "
                             "fetch it)")
        if tag in _LIBTIFF_SCALARS and tags.get(tag, (0,))[0] < 0:
            raise ValueError(f"tag {tag} negative (libtiff's range check)")
    if tags.get(284, (1,))[0] not in (1, 2):
        raise ValueError(f"PlanarConfiguration {tags[284][0]} (libtiff "
                         "refuses it)")
    offsets, counts = (striles.get(324), striles.get(325)) if 322 in tags \
        else (striles.get(273), striles.get(279))
    if offsets and counts:
        for o, c in zip(offsets, counts):
            if o + c > len(data):
                raise ValueError(f"a strip or tile of {c} bytes at {o}, past "
                                 "the file's end (libtiff's read error)")


def _key(order: str, tags: dict, compression: int):
    """Pillow's ``(mode, rawmode)`` for the IFD (``TiffImageFile._setup``)."""
    photo = tags.get(262, (0,))[0]
    if compression == 6:
        photo = 6
    fill = tags.get(266, (1,))[0]
    fmt = tuple(tags.get(339, (1,)))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tuple(tags.get(258, (1,)))
    extra = tuple(tags.get(338, ()))
    spp = tags.get(277, (3 if compression == 6 and photo in (2, 6) else 1,))[0]
    if spp > _MAX_SPP:
        raise _Unsupported("more samples per pixel than Pillow decodes")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise _Unsupported("unknown data organization")
    # fill order 2: each stored byte's bits reversed, before the codec (as
    # libtiff does; Pillow's raw decoder reverses them in the raw mode); the
    # plugin's key must have fill order 2 whatever the compression
    if fill == 2 and not (
            (photo, bps) in _FILL2 or (order, photo, bps) in _FILL2_ONE):
        raise _Unsupported("unknown pixel mode")
    if fill not in (1, 2):
        raise _Unsupported("unknown pixel mode")
    if (order, photo, fmt, bps) in _ONE_ORDER and not extra:
        mode, raw = _ONE_ORDER[(order, photo, fmt, bps)]
    elif (photo, fmt, bps, extra) in _OPEN_INFO:
        mode, raw = _OPEN_INFO[(photo, fmt, bps, extra)]
    else:
        raise _Unsupported(f"unknown pixel mode (photometric {photo}, sample "
                           f"format {fmt}, bits {bps}, extra samples {extra})")
    return mode, raw, photo, fill, bps, spp


def _inflate(chunk: bytes, compression: int, expected: int,
             fax: Optional[dict] = None) -> bytes:
    if compression == 1:
        return chunk
    if compression in _FAX:  # fax["rows"] rows of fax["width"] pixels
        w, rows, buf = fax["width"], fax["rows"], fax["buf"]
        ccitt.decode(chunk, compression, fax["options"], w, rows, fax["runs"],
                     buf)
        return np.packbits(buf[:rows], axis=1).tobytes()
    if compression == 50000:
        return zstd.decompress(chunk, expected)
    if compression in (5, 32773):
        lib = _native()
        out = np.zeros(expected, np.uint8)
        err = ctypes.create_string_buffer(256)
        fn = lib.tiff_lzw if compression == 5 else lib.tiff_packbits
        n = fn(chunk, len(chunk), out.ctypes.data, expected, err, len(err))
        if n < 0:
            raise ValueError(err.value.decode(errors="replace"))
        if compression == 5 and n < expected:  # libtiff's LZWDecode fails
            raise ValueError(f"LZW: not enough data ({expected - n} bytes "
                             "short of the strip or tile)")
        return out.tobytes()
    if compression in (8, 32946):
        return zlib.decompressobj().decompress(chunk, expected)
    if compression == 34925:
        return lzma.LZMADecompressor().decompress(chunk, expected)
    raise _Unsupported(f"compression {compression}")


def _jpeg_chunk(chunk: bytes, tables: Optional[bytes], photo: int,
                sampling: list, carry: dict, segment: tuple) -> np.ndarray:
    """One strip or tile of JPEG-in-TIFF (compression 7), in the colour
    space libtiff sets: YCbCr converted to RGB for photometric 6, the
    components as they are for RGB (2) and gray (1).  libtiff reads the
    ``JPEGTables`` once, before the first strip (spliced in before its
    frame here), and its one decompressor keeps the tables in force from
    strip to strip (``carry["tables"]``).  As libtiff's ``JPEGPreDecode``,
    the first component's sampling factors must be the YCbCrSubsampling
    tag's (``sampling[0]``; 1x1 for RGB and gray) and the others' 1x1;
    where the tag is absent (``sampling[0]`` None) libtiff's
    ``JPEGFixupTagsSubsampling`` takes the first strip's; a frame larger
    than the strip or tile (``segment``: width, height, whether it is the
    image's last strip) fails, but for the last strip's full-width taller
    one; a smaller one fills the top left of Pillow's strip buffer, whose
    other bytes keep the strip before's (``carry["rows"]``; in the first
    strip they are memory Pillow never initialised, and that raises).  A
    fault past the rows of a one-scan frame is let be, as libtiff lets it
    be."""
    if carry.get("tables") is None and tables and len(tables) > 4 and \
            chunk[:2] == b"\xff\xd8":
        chunk = chunk[:2] + tables[2:-2] + chunk[2:]
    # libtiff's source manager gives libjpeg a fake EOI where the strip's
    # bytes run out (std_fill_input_buffer), so a cut strip never waits
    chunk += b"\xff\xd9"
    space = {1: "L", 2: "RGB", 6: "YCbCr"}[photo]
    try:
        frame, jt, _ = jpeg._decode(chunk, False, carry.get("tables"),
                                    finish_fails=False)
        carry["tables"] = jt
        sw, sh, last = segment
        small = frame.w <= sw and frame.h <= sh and (frame.w, frame.h) != (
            sw, sh)
        if (frame.w, frame.h) != (sw, sh) and not small and not (
                last and frame.w == sw and frame.h > sh):
            raise ValueError(f"a JPEG frame of {frame.w}x{frame.h} in a strip "
                             f"or tile of {sw}x{sh} (libtiff fails)")
        if photo == 6 and sampling[0] is None:
            sampling[0] = frame.hv[0]
        want = tuple(sampling[0]) if photo == 6 else (1, 1)
        if frame.hv[0] != want or any(hv != (1, 1) for hv in frame.hv[1:]):
            raise _Unsupported(f"JPEG sampling factors {frame.hv} where "
                               f"libtiff takes {want} then 1x1")
        px, _ = jpeg._pixels(frame, jt, space, False, {})
    except jpeg._Unsupported as e:
        raise _Unsupported(f"JPEG-in-TIFF: {e}") from None
    px = px.reshape(px.shape[0], px.shape[1], -1)
    if small:  # libtiff reads the frame's rows into Pillow's strip buffer;
        # the rest keeps the strip before's bytes (none before the first)
        prev = carry.get("rows")
        if prev is None or prev.shape[0] < sh or prev.shape[1:] != (
                sw, px.shape[2]):
            raise ValueError(f"a JPEG frame of {frame.w}x{frame.h} in the "
                             f"first strip or tile, of {sw}x{sh} (libtiff "
                             "reads short rows into memory Pillow never "
                             "initialised)")
        rows = prev[:sh].copy()
        rows[:frame.h, :frame.w] = px[:frame.h, :frame.w]
        px = rows
    carry["rows"] = px
    return px


def _bits_per_row(width: int, spp: int, bits: int) -> int:
    return (width * spp * bits + 7) // 8


def _unpredict(buf: np.ndarray, predictor: int, rows: int, width: int,
               spp: int, bits: int, order: str, fmt=(3,)) -> np.ndarray:
    """Undo predictor 2 or 3 on a chunk's bytes (rows of ``width`` pixels
    of ``spp`` samples)."""
    if predictor == 1:
        return buf
    row_bytes = _bits_per_row(width, spp, bits)
    b = buf[:rows * row_bytes].reshape(rows, row_bytes)
    if predictor == 2:
        if bits not in (8, 16, 32):
            raise _Unsupported(f"predictor 2 with {bits}-bit samples")
        dt = np.dtype(f"{'<' if order == 'II' else '>'}u{bits // 8}")
        v = b.copy().view(dt).reshape(rows, width, spp)
        v = np.cumsum(v, axis=1, dtype=dt.newbyteorder("="))
        out = v.astype(dt).view(np.uint8).reshape(rows, row_bytes)
    elif predictor == 3:
        if bits not in (16, 32, 64) or fmt[0] != 3:
            raise _Unsupported(f"predictor 3 with {bits}-bit samples of format "
                               f"{fmt[0]} (libtiff takes IEEE floats only)")
        nb = bits // 8
        acc = b.reshape(rows, width * nb, spp)
        acc = np.cumsum(acc, axis=1, dtype=np.uint8).reshape(rows, row_bytes)
        # byte planes, most significant first -> native (little-endian)
        planes = acc.reshape(rows, nb, width * spp)
        out = planes[:, ::-1, :].transpose(0, 2, 1).reshape(rows, row_bytes)
        if order == "MM":  # the samples in the file's order for what follows
            out = out.reshape(rows, width * spp, nb)[..., ::-1].reshape(
                rows, row_bytes)
    else:
        raise _Unsupported(f"predictor {predictor}")
    return np.concatenate([out.reshape(-1), buf[rows * row_bytes:]])


def _samples(buf: np.ndarray, rows: int, width: int, spp: int, bits: int,
             order: str, fmt) -> np.ndarray:
    """(rows, width, spp) samples of a chunk's bytes: uint8 for 1/2/4/8
    bits, uint16 for 12/16, and uint32, int32 or float32 for 32."""
    row_bytes = _bits_per_row(width, spp, bits)
    need = rows * row_bytes
    if len(buf) < need:
        buf = np.concatenate([buf, np.zeros(need - len(buf), np.uint8)])
    b = buf[:need].reshape(rows, row_bytes)
    if bits in (1, 2, 4):
        bitsarr = np.unpackbits(b, axis=1)[:, :width * spp * bits]
        v = bitsarr.reshape(rows, width * spp, bits)
        weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
        return (v * weights).sum(-1).astype(np.uint8).reshape(rows, width, spp)
    if bits == 8:
        return b.reshape(rows, width, spp)
    if bits == 12:
        n = width * spp
        pairs = np.zeros((rows, (n + 1) // 2 * 3), np.uint16)
        pairs[:, :row_bytes] = b
        t = pairs.reshape(rows, -1, 3)
        v = np.stack([(t[..., 0] << 4) | (t[..., 1] >> 4),
                      ((t[..., 1] & 15) << 8) | t[..., 2]], -1)
        return v.reshape(rows, -1)[:, :n].reshape(rows, width, spp)
    e = "<" if order == "II" else ">"
    if bits == 16:
        return b.view(e + "u2").astype(np.uint16).reshape(rows, width, spp)
    if bits == 32:
        kind = {1: "u4", 2: "i4", 3: "f4"}.get(fmt[0])
        if kind is None:
            raise _Unsupported(f"sample format {fmt}")
        return b.view(e + kind).astype(np.dtype(kind)).reshape(rows, width,
                                                                 spp)
    raise _Unsupported(f"{bits}-bit samples")


def _read(data: bytes, order: str, tags: dict, spp: int, bits: int, fmt,
          compression: int, fill: int, photo: int, seconds: dict):
    """(H, W, spp) samples of the image, from its strips or tiles; each
    stage's seconds added to ``seconds``."""
    clock = time.perf_counter

    def spent(key, t0):
        seconds[key] = seconds.get(key, 0.0) + clock() - t0
    w, h = tags[256][0], tags[257][0]
    planar = tags.get(284, (1,))[0]
    # libtiff's predictor module serves LZW, Deflate and LZMA; Pillow's own
    # raw decoder and libtiff's PackBits and JPEG codecs ignore the tag
    predictor = (tags.get("libtiff", tags).get(317, (1,))[0] if compression
                 in (5, 8, 32946, 34925, 50000) else 1)
    if predictor not in (1, 2, 3):  # libtiff ignores the tag's value
        predictor = 1
    tables = tags.get(347)
    sampling = [tuple(tags[530][:2]) if 530 in tags else None]
    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp
    if 322 in tags:
        tw, th = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
        across, down = -(-w // tw), -(-h // th)
        boxes = [(x * tw, y * th, tw, th) for y in range(down)
                 for x in range(across)]
    else:
        rps = min(tags.get(278, (2 ** 32 - 1,))[0], h)
        offsets, counts = tags[273], tags.get(279)
        down = -(-h // rps)
        boxes = [(0, y * rps, w, min(rps, h - y * rps)) for y in range(down)]
        if counts is None:
            counts = (len(data),) * len(offsets)
    if compression == 1 and planes == 1:
        # Pillow's own decoder makes a tile of every offset, its boxes in
        # turn from the top again past the last: the tiles there are, each
        # read in full, the last one over a box winning
        boxes = [boxes[k % len(boxes)] for k in range(len(offsets))]
    elif len(offsets) < len(boxes) * planes:
        raise ValueError("fewer strips or tiles than the image needs")
    dtype = {1: np.uint8, 2: np.uint8, 4: np.uint8, 8: np.uint8,
             12: np.uint16, 16: np.uint16}.get(bits)
    if dtype is None:
        dtype = {1: np.uint32, 2: np.int32, 3: np.float32}.get(fmt[0],
                                                               np.uint32)
    out = np.zeros((h, w, spp), dtype)
    carry = {}  # libjpeg's tables in force from one JPEG strip to the next
    fax = None
    if compression in _FAX:  # libtiff's run arrays and Pillow's row buffer
        # live from one strip or tile to the next
        fw = boxes[0][2]
        options = tags.get(293 if compression == 4 else 292, (0,))[0]
        fax = {"width": fw, "options": options, "buf": np.zeros(
            (max(b[3] for b in boxes), fw), np.uint8), "runs": np.array(
                ccitt.run_buffer(fw, compression, options), np.uint32)}
    for p in range(planes):
        for i, (x0, y0, cw, chh) in enumerate(boxes):
            k = p * len(boxes) + i
            chunk = data[offsets[k]:offsets[k] + counts[k]]
            if compression == 1:  # Pillow's raw decoder reads the bytes the
                # rows take, whatever the count, and the file must hold them
                need = chh * _bits_per_row(cw, per, bits)
                chunk = data[offsets[k]:offsets[k] + need]
                if len(chunk) < need:
                    raise ValueError(f"image file is truncated ({len(chunk)}"
                                     f" of {need} bytes)")
            if fill == 2:
                chunk = _REVERSED[np.frombuffer(chunk, np.uint8)].tobytes()
            rows = chh
            t0 = clock()
            if compression == 7:
                px = _jpeg_chunk(chunk, tables, photo, sampling, carry, (
                    cw, chh, 322 not in tags and y0 + chh >= h))
                s = px.reshape(px.shape[0], px.shape[1], -1)[:rows, :cw]
                if s.shape[2] != per:
                    raise _Unsupported("a JPEG strip of other components")
                spent("jpeg", t0)
            else:
                need = rows * _bits_per_row(cw, per, bits)
                if fax is not None:
                    fax["rows"] = rows
                raw = np.frombuffer(_inflate(chunk, compression, need, fax),
                                    np.uint8)
                spent("inflate", t0)
                t0 = clock()
                raw = _unpredict(raw, predictor, min(rows, len(raw) // max(
                    1, _bits_per_row(cw, per, bits))), cw, per, bits, order, fmt)
                spent("predictor", t0)
                t0 = clock()
                s = _samples(raw, rows, cw, per, bits, order, fmt)
                spent("samples", t0)
            ww, hh = min(cw, w - x0), min(rows, h - y0)
            out[y0:y0 + hh, x0:x0 + ww, p:p + per] = s[:hh, :ww]
    return out


def _raw_ycbcr(data: bytes, tags: dict, mode: str) -> np.ndarray:
    """Uncompressed YCbCr, as Pillow's own raw decoder reads it: each strip
    or tile a ``raw`` tile of rawmode ``RGBX`` (four bytes a pixel, the
    subsampling ignored) from its offset, reading on past its bytes (a file
    that ends first raises "image file is truncated"); edge tiles at the
    stride of their full width's 3 bytes a pixel; one tile that covers the
    image reads from the last offset."""
    if tags.get(284, (1,))[0] != 1:
        raise _Unsupported("YCbCr in separate planes")
    w, h = tags[256][0], tags[257][0]
    if 322 in tags:
        offsets, tw, th = tags[324], tags[322][0], tags[323][0]
    else:
        offsets, tw, th = tags[273], w, tags.get(278, (h,))[0]
    if tw == w and th == h:
        offsets = offsets[-1:]
    out = np.zeros((h, w, 3), np.uint8)
    x = y = 0
    for offset in offsets:
        if y >= h:
            break
        box_w, box_h = min(x + tw, w) - x, min(y + th, h) - y
        stride = tw * 3 if x + tw > w else 0
        out[y:y + box_h, x:x + box_w] = unpack.raw(data, offset, (box_w, box_h),
                                                   mode, "RGBX", stride)
        x += tw
        if x >= w:
            x, y = 0, y + th
    return out


# ------------------------------------ YCbCr through libtiff's RGBA interface
# the (hs, vs) tif_getimage.c has a put routine for: contiguous units, and
# separate planes at 1x1 only (putseparate8bitYCbCr11tile)
_YCBCR_PUT = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
_F = np.float32


def _floats(tags: dict, tag: int, default) -> list:
    """A RATIONAL tag as libtiff reads it: each ``num / den`` in float32,
    0 where ``den`` is 0."""
    pairs = tags.get((tag, "pairs"))
    if pairs is None:
        return [_F(v) for v in default]
    return [_F(pairs[k]) / _F(pairs[k + 1]) if pairs[k + 1] else _F(0)
            for k in range(0, len(pairs), 2)]


def ycbcr_tables(tags: dict) -> np.ndarray:
    """``TIFFYCbCrToRGBInit``'s tables, (5, 256) int32: ``Y_tab``,
    ``Cr_r_tab``, ``Cb_b_tab``, ``Cr_g_tab`` and ``Cb_g_tab``, in float32
    and 16.16 fixed point as libtiff computes them from ``YCbCrCoefficients``
    (529; 0.299, 0.587, 0.114) and ``ReferenceBlackWhite`` (532; 0, 255,
    128, 255, 128, 255).  Raises as ``initYCbCrConversion`` refuses."""
    luma = _floats(tags, 529, (0.299, 0.587, 0.114))
    rbw = _floats(tags, 532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))
    if len(luma) < 3 or len(rbw) < 6 or any(np.isnan(luma)) or luma[1] == 0:
        raise ValueError("invalid YCbCrCoefficients (libtiff refuses them)")
    if not all(_F(-0x7FFFFFFF + 128) < v < _F(0x7FFFFFFF) for v in rbw):
        raise ValueError("invalid ReferenceBlackWhite (libtiff refuses it)")

    def clamp(f, lo, hi):
        return lo if not f >= lo else hi if f > hi else f

    def fix(x):  # FIX: (int32)(x * 65536 + 0.5)
        return int(np.float64(x * _F(65536)) + 0.5)

    def code2v(c, rb, rw, cr):  # (c - (int32)RB) * (float)CR / (RW - RB)
        d = rw - rb
        return _F(c - int(rb)) * _F(cr) / (d if d != 0 else _F(1))

    def clampw(f):  # CLAMPw to +-4096, then C's cast: truncated
        return int(-4096.0 if f < _F(-4096) else 4096.0 if f > _F(4096)
                   else f)
    red, green, blue = luma
    f1 = _F(2) - _F(2) * red
    f3 = _F(2) - _F(2) * blue
    d1, d3 = fix(clamp(f1, _F(0), _F(2))), fix(clamp(f3, _F(0), _F(2)))
    d2 = -fix(clamp(red * f1 / green, _F(0), _F(2)))
    d4 = -fix(clamp(blue * f3 / green, _F(0), _F(2)))
    out = np.zeros((5, 256), np.int64)
    for i in range(256):
        x = i - 128
        cr = clampw(code2v(x, rbw[4] - _F(128), rbw[5] - _F(128), 127))
        cb = clampw(code2v(x, rbw[2] - _F(128), rbw[3] - _F(128), 127))
        out[:, i] = (clampw(code2v(x + 128, rbw[0], rbw[1], 255)),
                     (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16,
                     d2 * cr, d4 * cb + 32768)
    return out.astype(np.int32)


def ycbcr_rgb_plain(units: np.ndarray, w: int, h: int, hs: int, vs: int,
                    fromskew: int, tabs: np.ndarray) -> np.ndarray:
    """(h, w, 3) RGB of one strip's or tile's packed units, as
    ``putcontig8bitYCbCr<hs><vs>tile`` puts them (``csrc/tiff_decode.cpp``,
    ``tiff_ycbcr``): numpy."""
    unit = hs * vs + 2
    across, down = -(-w // hs), -(-h // vs)
    skew = (fromskew // hs) * (10 if (hs, vs) == (4, 4) else unit)
    start = np.arange(down)[:, None] * (across * unit + skew) + \
        np.arange(across)[None, :] * unit
    if down and start[-1, -1] + unit > len(units):
        raise ValueError("YCbCr units run past the strip or tile")
    u = units[start[..., None] + np.arange(unit)].astype(np.int64)
    luma = u[..., :hs * vs].reshape(down, across, vs, hs).transpose(
        0, 2, 1, 3).reshape(down * vs, across * hs)[:h, :w]
    cb = np.repeat(np.repeat(u[..., -2], vs, 0), hs, 1)[:h, :w]
    cr = np.repeat(np.repeat(u[..., -1], vs, 0), hs, 1)[:h, :w]
    t = tabs.astype(np.int64)
    y = t[0][luma]
    rgb = (y + t[1][cr], y + ((t[4][cb] + t[3][cr]) >> 16), y + t[2][cb])
    return np.clip(np.stack(rgb, -1), 0, 255).astype(np.uint8)


def ycbcr_rgb(units: np.ndarray, w: int, h: int, hs: int, vs: int,
              fromskew: int, tabs: np.ndarray, out: np.ndarray = None
              ) -> np.ndarray:
    """The C++ stage: ``ycbcr_rgb_plain``'s output, written into ``out``
    ((h, w, 3) uint8, rows of any stride) where given."""
    units = np.ascontiguousarray(units, np.uint8)
    tabs = np.ascontiguousarray(tabs, np.int32)
    if out is None:
        out = np.zeros((h, w, 3), np.uint8)
    assert out.strides[1:] == (3, 1) and out.shape[:2] == (h, w)
    got = _native().tiff_ycbcr(units.ctypes.data, len(units), w, h, hs, vs,
                               fromskew, tabs.ctypes.data, out.ctypes.data,
                               out.strides[0])
    if got < 0:
        raise ValueError("YCbCr units run past the strip or tile")
    return out


def _rgba_ycbcr(data: bytes, order: str, tags: dict, compression: int,
                fill: int, seconds: dict) -> np.ndarray:
    """YCbCr compressed other than as JPEG, as Pillow's libtiff decoder
    reads it through ``TIFFRGBAImageGet`` (``_decodeAsRGBA``): each strip or
    tile decoded to its packed size (``TIFFVStripSize`` of the strip's rows
    rounded up to ``vs``, at ``TIFFScanlineSize`` a row; ``TIFFVTileSize``),
    predictor 2 on libtiff's rows of those bytes (the scanline, or
    ``TIFFTileRowSize``: 3 bytes a pixel of the tile's width), left undone
    where the rows do not divide (libtiff's predictor refuses the chunk,
    and ``TIFFRGBAImageGet`` goes on with its bytes), then ``tiff_ycbcr``.
    YCbCrSubsampling defaults to 2x2; separate planes only at 1x1.  The
    orientation is left to ``_decode``: Pillow's transpose after this read
    is all that shows.  (At 4x4 a strip whose row of units is not a
    multiple of 4 bytes reads short by libtiff's truncated scanline; Pillow
    leaves those bytes as its buffer held them, here zeros.)"""
    clock = time.perf_counter
    hs, vs = tuple(tags[530][:2]) if 530 in tags else (2, 2)
    planar = tags.get(284, (1,))[0]
    if (hs, vs) not in _YCBCR_PUT or (planar == 2 and (hs, vs) != (1, 1)):
        raise _Unsupported(f"YCbCr subsampling {hs}x{vs}" + (
            " in separate planes" if planar == 2 else "") + " (libtiff's "
            "RGBA interface has no routine for it)")
    predictor = tags.get(317, (1,))[0] if compression in (
        5, 8, 32946, 34925, 50000) else 1
    if predictor not in (1, 2):
        raise _Unsupported(f"predictor {predictor} on 8-bit YCbCr")
    tabs = ycbcr_tables(tags)
    w, h = tags[256][0], tags[257][0]
    out = np.zeros((h, w, 3), np.uint8)
    if (hs, vs) == (1, 1):  # one unit a pixel: the samples as they are read
        s = _read(data, order, tags, 3, 8, (1,), compression, fill, 6,
                  seconds)
        t0 = clock()
        ycbcr_rgb(s.reshape(-1), w, h, 1, 1, 0, tabs, out)
        seconds["ycbcr"] = seconds.get("ycbcr", 0.0) + clock() - t0
        return out
    unit = hs * vs + 2
    if 322 in tags:
        tw, th = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
        boxes = [(x, y, tw, th) for y in range(0, h, th)
                 for x in range(0, w, tw)]
        sizes = [-(-th // vs) * -(-tw // hs) * unit] * len(boxes)
        row = tw * 3
    else:
        rps = min(tags.get(278, (2 ** 32 - 1,))[0], h)
        offsets, counts = tags[273], tags.get(279)
        boxes = [(0, y, w, min(rps, h - y)) for y in range(0, h, rps)]
        row = -(-w // hs) * unit // vs
        sizes = [-(-b[3] // vs) * vs * row for b in boxes]
        if counts is None:
            counts = (len(data),) * len(offsets)
    if len(offsets) < len(boxes):
        raise ValueError("fewer strips or tiles than the image needs")
    for k, (x0, y0, cw, ch) in enumerate(boxes):
        chunk = data[offsets[k]:offsets[k] + counts[k]]
        if fill == 2:
            chunk = _REVERSED[np.frombuffer(chunk, np.uint8)].tobytes()
        t0 = clock()
        raw = np.zeros(sizes[k], np.uint8)
        got = np.frombuffer(_inflate(chunk, compression, sizes[k]), np.uint8)
        raw[:len(got)] = got[:sizes[k]]
        seconds["inflate"] = seconds.get("inflate", 0.0) + clock() - t0
        if predictor == 2 and row % 3 == 0 and sizes[k] % row == 0:
            raw = np.cumsum(raw.reshape(-1, row // 3, 3), axis=1,
                            dtype=np.uint8).reshape(-1)
        t0 = clock()
        this_w, this_h = min(cw, w - x0), min(ch, h - y0)
        ycbcr_rgb(raw, this_w, this_h, hs, vs, cw - this_w, tabs,
                  out[y0:y0 + this_h, x0:x0 + this_w])
        seconds["ycbcr"] = seconds.get("ycbcr", 0.0) + clock() - t0
    return out


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """``unpackRGBa``: ``CLIP8(c * 255 / a)``, all zero where ``a`` is 0."""
    a = rgba[..., 3:].astype(np.int64)
    c = rgba[..., :3].astype(np.int64)
    rgb = np.where(a == 255, c, np.minimum(c * 255 // np.maximum(a, 1), 255))
    rgb = np.where(a == 0, 0, rgb)
    return np.concatenate([rgb, a], -1).astype(np.uint8)


def _pixels(s: np.ndarray, mode: str, raw: str, order: str, compressed: bool):
    """The mode's pixels from (H, W, spp) samples, as the raw mode's
    unpacker makes them."""
    if raw.startswith("1"):
        v = s[..., 0] if raw == "1" else 1 - s[..., 0]
        return (v * 255).astype(np.uint8)
    if raw.startswith("L;2") or raw.startswith("L;4"):
        top = 3 if raw.startswith("L;2") else 15
        v = s[..., 0].astype(np.int32)
        if raw.endswith("I"):
            v = top - v
        return (v * (255 // top)).astype(np.uint8)
    if raw == "L;I":
        return 255 - s[..., 0]
    if raw in ("L", "P", "PX", "I;12", "I;16", "I;16B"):
        return s[..., 0]
    if raw in ("LA", "PA"):
        return s[..., :2]
    if raw in ("I;16S", "I;16BS", "I;32N", "I;32S", "I;32BS", "F;32F",
               "F;32BF"):
        v = s[..., 0]
        if raw in ("I;16S", "I;16BS"):
            v = v.astype(np.int16)
        if compressed and raw in ("I;16BS", "I;32BS", "F;32BF"):
            v = v.byteswap()  # native samples read as big-endian
        return v.astype(np.float32 if mode == "F" else np.int32)
    if raw.startswith("P;"):
        return s[..., 0]
    if raw.endswith(";16"):
        s = (s >> 8).astype(np.uint8)
        raw = raw[:-3]
    n = {"RGB": 3, "RGBX": 3, "RGBXX": 3, "RGBXXX": 3, "RGBA": 4,
         "RGBAX": 4, "RGBAXX": 4, "RGBa": 4, "RGBaX": 4, "RGBaXX": 4,
         "CMYK": 4, "CMYKX": 4, "CMYKXX": 4, "LAB": 3}[raw]
    px = np.ascontiguousarray(s[..., :n])
    if raw.startswith("RGBa"):
        px = _unpremultiply(px)
    return px


def decode(data: bytes, name: str = "TIFF", seconds: Optional[dict] = None):
    """``(pixels, mode, palette, transparency)``: a TIFF file's first image
    as Pillow opens it.  ``seconds``, where given, receives the time of
    each stage (``inflate``, ``predictor``, ``samples``, ``jpeg``,
    ``pixels``)."""
    try:
        return _decode(data, name, {} if seconds is None else seconds)
    except _Unsupported as e:
        raise ValueError(f"{name}: unsupported TIFF: {e}") from None
    except (struct.error, zlib.error, lzma.LZMAError, KeyError, IndexError,
            ValueError) as e:
        if isinstance(e, ValueError) and str(e).startswith(f"{name}: "):
            raise
        raise ValueError(f"{name}: a corrupt TIFF ({e!r})") from None


def _decode(data: bytes, name: str, seconds: dict):
    order = data[:2].decode()
    # as TiffImagePlugin: only a third byte of 43 marks BigTIFF, so a
    # big-endian BigTIFF header is read as a classic one (and fails)
    big = data[2] == 43
    tags = _ifd(data, order, big)
    if 0xBC01 in tags:
        raise _Unsupported("Windows Media Photo")
    w, h = tags[256][0], tags[257][0]
    if w * h > _BOMB_PIXELS:  # Image.open's DecompressionBombError
        raise ValueError(f"{w}x{h} pixels, past Pillow's decompression bomb "
                         "limit")
    compression = tags.get(259, (1,))[0]
    if compression not in _COMPRESSIONS:
        raise _Unsupported(f"compression {compression}" + (
            f" ({_UNREAD[compression]}, which this Pillow's libtiff lacks too)"
            if compression in _UNREAD else ""))
    mode, raw, photo, fill, bps, spp = _key(order, tags, compression)
    if compression != 1:  # Pillow hands the file to libtiff
        _libtiff_refuses(data, order, tags)
    if compression in _FAX and bps != (1,) * spp:
        raise _Unsupported("CCITT compression of other than 1-bit samples")
    if tags.get(284, (1,))[0] == 2 and spp > 1 and bps[0] != 8:
        raise _Unsupported(f"separate planes of {bps[0]}-bit samples (Pillow "
                           "unpacks them as 8-bit bands)")
    fmt = tuple(tags.get(339, (1,)))
    if compression == 7:
        if tags.get(284, (1,))[0] != 1 or photo not in (1, 2, 6):
            raise _Unsupported("JPEG compression other than YCbCr, RGB or "
                               "gray, contiguous")
        if photo == 6:
            raw = "RGB"
    elif photo == 6 and spp != 3 and compression != 1:
        raise _Unsupported("YCbCr of one sample (libtiff refuses it)")
    if photo == 6 and spp == 3 and compression == 1:
        px = _raw_ycbcr(data, tags, mode)
    elif photo == 6 and compression != 7:
        px = _rgba_ycbcr(data, order, tags, compression, fill, seconds)
    else:
        s = _read(data, order, tags, spp, bps[0], fmt, compression, fill,
                  photo, seconds)
        t0 = time.perf_counter()
        px = _pixels(s, mode, raw, order, compression != 1)
        seconds["pixels"] = time.perf_counter() - t0
    palette = None
    if mode in ("P", "PA"):
        cmap = np.array(tags[320], np.uint16)
        n = len(cmap) // 3
        palette = (cmap.reshape(3, n).T >> 8).astype(np.uint8)
    orientation = _orientation(tags)
    if (274 in tags and orientation in (5, 6, 7, 8) and compression == 1
            and mode == raw and mode in _MAPMODES and _one_tile(tags)):
        # ImageFile.load maps a lone raw tile at the open size, which
        # ``_setup`` swapped for these orientations: the rows are read at
        # the other width before the transpose
        px = px.reshape((px.shape[1], px.shape[0]) + px.shape[2:])
    # the open size: ``_setup`` swaps it for tag 274's orientations 5-8
    # only, so an XMP orientation transposes after the open saw (w, h)
    w, h = tags[256][0], tags[257][0]
    size = (h, w) if 274 in tags and orientation in (5, 6, 7, 8) else (w, h)
    if orientation != 1:
        px = np.ascontiguousarray(_TRANSPOSE[orientation](px))
    opened = (mode, size) if size != (px.shape[1], px.shape[0]) else None
    # Pillow's LAB unpacker flips a and b into the core image and sets its
    # pixels' fourth byte; bands read from separate planes are not flipped
    # (its array flips them back) and leave that byte 0
    pad = 0
    if mode == "LAB" and tags.get(284, (1,))[0] == 1:
        pad = 255
    elif mode == "LAB":
        px = px ^ np.array([0, 128, 128], np.uint8)
    return px, mode, palette, None, opened, pad


# ``ImageOps.exif_transpose``'s method for each orientation, on (H, W[, C])
_TRANSPOSE = {
    2: lambda p: p[:, ::-1],                       # FLIP_LEFT_RIGHT
    3: lambda p: p[::-1, ::-1],                    # ROTATE_180
    4: lambda p: p[::-1],                          # FLIP_TOP_BOTTOM
    5: lambda p: p.swapaxes(0, 1),                 # TRANSPOSE
    6: lambda p: np.rot90(p, -1),                  # ROTATE_270
    7: lambda p: np.rot90(p, 2).swapaxes(0, 1),    # TRANSVERSE
    8: lambda p: np.rot90(p, 1),                   # ROTATE_90
}
_XMP_ORIENTATION = re.compile(rb'tiff:Orientation(="|>)([0-9])')


# Image._MAPMODES: the modes ImageFile.load maps straight from the file
_MAPMODES = ("L", "P", "RGBX", "RGBA", "RGBa", "I;16", "I;16L", "I;16B")


def _one_tile(tags: dict) -> bool:
    """Whether Pillow's ``_setup`` makes one raw tile of the image."""
    w, h = tags[256][0], tags[257][0]
    if 322 in tags:
        offsets, tw, th = tags[324], tags[322][0], tags[323][0]
    else:
        offsets, tw, th = tags[273], w, tags.get(278, (h,))[0]
    return len(offsets) == 1 or ((tw, th) == (w, h)
                                 and tags.get(284, (1,))[0] != 2)


def _orientation(tags: dict) -> int:
    """The orientation ``load_end`` applies: tag 274, else the XMP
    packet's (``Image.getexif``); 1 (none) for any value outside 2-8."""
    if 274 in tags:
        o = tags[274][0] if tags[274] else 1
    else:
        xmp = tags.get(700, b"")
        m = _XMP_ORIENTATION.search(bytes(xmp))
        o = int(m[2]) if m else 1
    return o if o in _TRANSPOSE else 1
