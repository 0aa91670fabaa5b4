"""An animated GIF89a writer on numpy and the standard library.

``write_gif(path, frames, fps=30)`` stands in for ``imageio.mimsave(path,
frames, fps=30)`` (``nerf_pl_tpu/tools/evaluate.py:190-192``): the same
frame count, the same frame delay (``int(100 / fps)`` hundredths of a
second, as imageio's Pillow writer rounds ``1000 / fps`` ms) and, like it,
no loop extension.  The bytes differ: each frame carries its own 256-colour
table from a median cut of its colours, and its pixels are LZW-coded
(variable-width codes from 9 to 12 bits, a clear code when the table is
full).

Quantisation: a frame with at most 256 colours is stored exactly; otherwise
each pixel takes the mean colour of its median-cut box, and the cut always
splits the box with the widest channel range, which bounds the error by the
widest range left after 255 cuts.
"""
from __future__ import annotations

import struct

import numpy as np

_MIN_CODE_SIZE = 8  # 256-colour tables
_MAX_CODES = 4096   # 12-bit codes


def _median_cut(img: np.ndarray):
    """``(palette (256, 3) uint8, index (H, W) uint8)`` for an (H, W, 3)
    uint8 frame."""
    px = img.reshape(-1, 3).astype(np.int64)
    key = (px[:, 0] << 16) | (px[:, 1] << 8) | px[:, 2]
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    cols = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], 1)

    def entry(members):
        ext = cols[members].max(0) - cols[members].min(0)
        return int(ext.max()), int(ext.argmax()), members

    boxes = [entry(np.arange(len(uniq)))]
    while len(boxes) < 256:
        i = max(range(len(boxes)), key=lambda j: boxes[j][0])
        width, ch, members = boxes[i]
        if width == 0:
            break  # every box holds one colour
        order = members[np.argsort(cols[members, ch], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = int(np.searchsorted(cum, cum[-1] / 2.0)) + 1
        cut = min(max(cut, 1), len(order) - 1)
        boxes[i] = entry(order[:cut])
        boxes.append(entry(order[cut:]))
    palette = np.zeros((256, 3), np.uint8)
    lut = np.empty(len(uniq), np.uint8)
    for j, (_, _, members) in enumerate(boxes):
        w = counts[members][:, None]
        palette[j] = np.round((cols[members] * w).sum(0) / w.sum())
        lut[members] = j
    return palette, lut[inv].reshape(img.shape[:2])


def _lzw(data: bytes) -> bytes:
    """GIF's LZW of a string of 8-bit colour indices, bits packed from the
    least significant end."""
    clear, eoi = 1 << _MIN_CODE_SIZE, (1 << _MIN_CODE_SIZE) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    def fresh():
        return ({bytes([i]): i for i in range(clear)}, eoi + 1,
                _MIN_CODE_SIZE + 1)

    table, nxt, size = fresh()
    emit(clear, size)
    w = data[:1]
    for i in range(1, len(data)):
        c = data[i:i + 1]
        wc = w + c
        if wc in table:
            w = wc
            continue
        emit(table[w], size)
        if nxt < _MAX_CODES:
            table[wc] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear, size)
            table, nxt, size = fresh()
        w = c
    if w:
        emit(table[w], size)
    emit(eoi, size)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def write_gif(path: str, frames, fps: float = 30) -> None:
    """Write (H, W, 3) uint8 frames, all of one size, as an animated GIF."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w, 3):
            raise ValueError(f"frames must be ({h}, {w}, 3) uint8, got "
                             f"{f.shape} {f.dtype}")
    delay = int(1000.0 / fps / 10)  # hundredths of a second
    body = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0, 0, 0))
    for f in frames:
        palette, index = _median_cut(f)
        body += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        body += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87)
        body += palette.tobytes()
        body.append(_MIN_CODE_SIZE)
        data = _lzw(index.tobytes())
        for i in range(0, len(data), 255):
            block = data[i:i + 255]
            body.append(len(block))
            body += block
        body.append(0)
    body.append(0x3B)
    with open(path, "wb") as fh:
        fh.write(bytes(body))
