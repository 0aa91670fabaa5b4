"""A PNG reader and writer on ``zlib`` alone.

Reads every layout Pillow's ``PngImagePlugin`` reads (its ``_MODES``): 1-,
2-, 4-, 8- and 16-bit gray, 8- and 16-bit RGB, gray + alpha and RGBA, and
1-, 2-, 4- and 8-bit palette, with or without Adam7 interlacing, with the
five scanline filters, and the ``tRNS`` chunk as Pillow keeps it; each in
Pillow's mode and values (``decode_png``).  Anything else raises
``ValueError`` naming the file.  Writes 8-bit gray, gray + alpha, RGB and
RGBA, filter 0.
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
    """The chunks up to IEND or the end of the file.  As Pillow does, only
    the CRCs of the chunks before the first IDAT are checked
    (``PngImageFile._open``; ``load_read`` and ``load_end`` skip the later
    ones), and a file that ends after its image data without IEND is
    read.  An IDAT that runs past the end of the file gives the bytes that
    are there (``load_read`` reads what the file holds)."""
    pos = len(_SIGNATURE)
    before_idat = True
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        before_idat &= kind != b"IDAT"
        if kind == b"IDAT" and len(body) != n:
            yield kind, body
            return
        if len(body) != n or (before_idat and pos + 12 + n > len(data)):
            raise ValueError("truncated PNG chunk")
        if before_idat and zlib.crc32(kind + body) != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    if before_idat:
        raise ValueError("PNG without image data")


def _inflate(data: bytes, rows) -> bytes:
    """The filtered rows (``rows``: each one's bytes, in the order they are
    stored) that Pillow's zip decoder takes from the IDAT data: it stops at
    the last row or where the zlib stream ends at a row's end (the rows
    after stay zero); a stream that ends mid-row, or data that ends before
    the stream, raises as Pillow's "image file is truncated"."""
    total = sum(rows)
    d = zlib.decompressobj()
    out = d.decompress(data, total)
    if len(out) >= total:
        return out
    if d.eof and len(out) in set(np.cumsum(rows).tolist()):
        return out + bytes(total - len(out))
    raise ValueError("image file is truncated")


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


# (bit depth, colour type) -> Pillow's mode (``PngImagePlugin._MODES``)
_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L",
          (16, 0): "I;16", (8, 2): "RGB", (16, 2): "RGB", (1, 3): "P",
          (2, 3): "P", (4, 3): "P", (8, 3): "P", (8, 4): "LA",
          (16, 4): "RGBA", (8, 6): "RGBA", (16, 6): "RGBA"}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _samples(raw: bytes, h: int, w: int, depth: int, ch: int):
    """One (sub-)image's filtered rows -> ((h, w, ch) samples, bytes used)."""
    row = -(-w * ch * depth // 8)
    n = h * (row + 1)
    if len(raw) < n:
        raise ValueError("PNG image data is too short")
    if depth >= 8:
        rows = _unfilter(raw[:n], h, w, ch * depth // 8)
    else:
        rows = _unfilter(raw[:n], h, row, 1)
    if depth == 16:
        return rows.view(">u2").reshape(h, w, ch).astype(np.uint16), n
    if depth == 8:
        return rows.reshape(h, w, ch), n
    bits = np.unpackbits(rows, axis=1).reshape(h, row * 8 // depth, depth)
    vals = np.zeros(bits.shape[:2], np.uint8)
    for i in range(depth):
        vals = (vals << 1) | bits[..., i]
    return vals[:, :w * ch].reshape(h, w, ch), n


def decode_png(data: bytes, name: str = "PNG"):
    """``(pixels, mode, palette, transparency)`` as Pillow opens the file:
    ``mode`` one of ``1 L I;16 RGB P LA RGBA``; pixels uint8 (H, W[, C])
    (``1``: 0 or 255; 2- and 4-bit gray scaled to 8 bits; 16-bit RGB and
    RGBA their high bytes; 16-bit gray + alpha as RGBA), uint16 for
    ``I;16``, palette indices for ``P``; ``palette`` (n, 3) uint8 for
    ``P``; ``transparency`` Pillow's ``info["transparency"]`` (an int, a
    tuple or bytes) or None."""
    try:
        return _decode_png(data, name)
    except (zlib.error, struct.error, IndexError, ValueError) as e:
        if isinstance(e, ValueError) and str(e).startswith(f"{name}: "):
            raise
        raise ValueError(f"{name}: a corrupt PNG ({e})") from None


def _decode_png(data: bytes, name: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    header, idat, plte, trns = None, [], None, None
    run = 0  # 0: before the IDATs, 1: in their first run, 2: after it
    for kind, body in _chunks(data):
        run = max(run, 2 if run == 1 and kind != b"IDAT" else
                  1 if kind == b"IDAT" else 0)
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT" and run == 1:  # load_read stops at another chunk
            idat.append(body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = header
    if (depth, ctype) not in _MODES or comp != 0 or filt != 0 or interlace > 1:
        raise ValueError(f"{name}: unsupported PNG (bit depth {depth}, colour "
                         f"type {ctype}, interlace {interlace})")
    mode = _MODES[(depth, ctype)]
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpr = lambda sw: 1 + -(-sw * ch * depth // 8)  # a filtered row's bytes
    if interlace:
        rows = [bpr(-(-(w - x0) // dx)) for x0, y0, dx, dy in _ADAM7
                if w > x0 and h > y0 for _ in range(-(-(h - y0) // dy))]
    else:
        rows = [bpr(w)] * h
    raw = _inflate(b"".join(idat), rows)
    if interlace:
        pix = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            sw, sh = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if sw <= 0 or sh <= 0:
                continue
            sub, n = _samples(raw[pos:], sh, sw, depth, ch)
            pix[y0::dy, x0::dx] = sub
            pos += n
    else:
        pix, _ = _samples(raw, h, w, depth, ch)
    palette, transparency = None, None
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{name}: a palette PNG without PLTE")
        palette = np.frombuffer(plte, np.uint8)[:len(plte) // 3 * 3].reshape(-1, 3)
    if trns is not None:  # PngStream.chunk_tRNS
        if ctype == 3:
            zero = trns.find(b"\0")
            simple = zero >= 0 and trns.count(b"\0") == 1 and all(
                b in (0, 255) for b in trns)
            transparency = zero if simple else trns
        elif ctype == 0 and len(trns) >= 2:
            key = int.from_bytes(trns[:2], "big")
            transparency = (255 if key else 0) if mode == "1" else key
        elif ctype == 2 and len(trns) >= 6:
            transparency = tuple(int.from_bytes(trns[i:i + 2], "big")
                                 for i in (0, 2, 4))
    if depth == 16:
        if mode == "I;16":
            return pix[..., 0], mode, palette, transparency
        pix = (pix >> 8).astype(np.uint8)
        if ctype == 4:  # "LA;16B" unpacked into RGBA
            pix = pix[..., [0, 0, 0, 1]]
    elif depth < 8 and ctype == 0:
        pix = pix * np.uint8(255 // ((1 << depth) - 1))
    pix = np.ascontiguousarray(pix)
    return (pix[..., 0] if pix.shape[2] == 1 else pix), mode, palette, transparency


def read_png(path: str):
    """``(pixels, mode)`` of a PNG as Pillow opens it (``decode_png``; the
    palette and transparency are in ``read_picture``'s result)."""
    with open(path, "rb") as f:
        data = f.read()
    pix, mode, _, _ = decode_png(data, path)
    return pix, mode


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
