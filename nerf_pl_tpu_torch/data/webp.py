"""A WebP reader: what Pillow's ``WebPImagePlugin`` gives for frame 0.

Pillow opens every WebP file through libwebp's ``WebPAnimDecoder``: its
mode is ``RGBA`` where the container's flags say the image has alpha (the
``VP8X`` alpha flag, or a ``VP8L`` header's alpha hint) and ``RGB``
otherwise, and frame 0 is decoded onto a canvas cleared to transparent
black (not to ``ANIM``'s background colour), at its ``ANMF`` offset.
This module reads the RIFF container (simple ``VP8 `` / ``VP8L``, and
extended ``VP8X`` with ``ALPH``, ``ANIM``/``ANMF``; ``ICCP``, ``EXIF`` and
``XMP `` skipped) and composes the canvas; the bitstreams are decoded by
the C++ stages of ``csrc/webp_decode.cpp`` (built with g++ at first use
through ``data/native.py``; a failed build raises, naming the source):
VP8L lossless, VP8 lossy with libwebp's fancy upsampling and YUV -> RGB,
and ``ALPH`` alpha planes.
"""
from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from . import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "webp_decode.cpp"
_ALPHA_FLAG, _ANIMATION_FLAG = 0x10, 0x02

_lock = threading.Lock()
_lib = None


def _native():
    """The C++ stages, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SOURCE)))
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            for name in ("webp_vp8l", "webp_vp8"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_char_p, i64, i32, i32, vp, vp,
                               ctypes.c_char_p, ctypes.c_int]
            lib.webp_alpha.restype = ctypes.c_int
            lib.webp_alpha.argtypes = [ctypes.c_char_p, i64, i32, i32, vp,
                                       ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


def _check(rc: int, err, name: str) -> None:
    if rc != 0:
        raise ValueError(f"{name}: a corrupt WebP file "
                         f"({err.value.decode(errors='replace')})")


def _chunks(data: bytes, start: int, end: int, name: str):
    pos = start
    while pos + 8 <= end:
        kind, n = struct.unpack("<4sI", data[pos:pos + 8])
        if pos + 8 + n > end:
            raise ValueError(f"{name}: truncated WebP chunk {kind!r}")
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 8 + n + (n & 1)


def _vp8_size(body: bytes, name: str):
    if len(body) < 10 or body[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{name}: a corrupt VP8 frame header")
    w, h = struct.unpack("<HH", body[6:10])
    return w & 0x3FFF, h & 0x3FFF


def _vp8l_size(body: bytes, name: str):
    if len(body) < 5 or body[0] != 0x2F:
        raise ValueError(f"{name}: a corrupt VP8L header")
    bits = int.from_bytes(body[1:5], "little")
    return ((bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1,
            bool((bits >> 28) & 1))


def _frame(chunks, name: str, seconds: Optional[dict]):
    """(H, W, 4) uint8 RGBA of one frame's ``[ALPH] VP8`` or ``VP8L``."""
    lib = _native()
    err = ctypes.create_string_buffer(256)
    stages = np.zeros(3, np.float64)
    alph = None
    for kind, body in chunks:
        if kind == b"ALPH":
            alph = body
        elif kind in (b"VP8 ", b"VP8L"):
            lossy = kind == b"VP8 "
            w, h = (_vp8_size(body, name) if lossy
                    else _vp8l_size(body, name)[:2])
            out = np.zeros((h, w, 4), np.uint8)
            out[..., 3] = 255
            fn = lib.webp_vp8 if lossy else lib.webp_vp8l
            _check(fn(body, len(body), w, h, out.ctypes.data,
                      stages.ctypes.data, err, len(err)), err, name)
            if lossy and alph is not None:
                alpha = np.empty((h, w), np.uint8)
                _check(lib.webp_alpha(alph, len(alph), w, h, alpha.ctypes.data,
                                      err, len(err)), err, name)
                out[..., 3] = alpha
            if seconds is not None:
                keys = (("parse_reconstruct", "loop_filter", "upsample_rgb")
                        if lossy else ("entropy", "transforms"))
                for k, v in zip(keys, stages):
                    seconds[k] = seconds.get(k, 0.0) + float(v)
            return out
    raise ValueError(f"{name}: a WebP frame without image data")


def decode(data: bytes, name: str = "WebP", seconds: Optional[dict] = None):
    """``(pixels, mode)``: frame 0 of a WebP file as Pillow opens it, in
    mode ``RGB`` (H, W, 3) or ``RGBA`` (H, W, 4), uint8.  ``seconds``, where
    given, receives the time of each C++ stage."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError(f"{name}: not a WebP file")
    end = min(len(data), 8 + struct.unpack("<I", data[4:8])[0])
    chunks = list(_chunks(data, 12, end, name))
    if not chunks:
        raise ValueError(f"{name}: an empty WebP file")
    kind, body = chunks[0]
    if kind == b"VP8 ":
        return _frame(chunks[:1], name, seconds)[..., :3], "RGB"
    if kind == b"VP8L":
        alpha = _vp8l_size(body, name)[2]
        px = _frame(chunks[:1], name, seconds)
        return (px, "RGBA") if alpha else (px[..., :3], "RGB")
    if kind != b"VP8X" or len(body) < 10:
        raise ValueError(f"{name}: a WebP file that starts with {kind!r}")
    flags = body[0]
    cw = int.from_bytes(body[4:7], "little") + 1
    ch = int.from_bytes(body[7:10], "little") + 1
    mode = "RGBA" if flags & _ALPHA_FLAG else "RGB"
    canvas = np.zeros((ch, cw, 4), np.uint8)
    if flags & _ANIMATION_FLAG:
        frames = [b for k, b in chunks if k == b"ANMF"]
        if not frames:
            raise ValueError(f"{name}: an animated WebP file without frames")
        anmf = frames[0]
        if len(anmf) < 16:
            raise ValueError(f"{name}: a corrupt ANMF chunk")
        x = 2 * int.from_bytes(anmf[0:3], "little")
        y = 2 * int.from_bytes(anmf[3:6], "little")
        fw = int.from_bytes(anmf[6:9], "little") + 1
        fh = int.from_bytes(anmf[9:12], "little") + 1
        px = _frame(_chunks(anmf, 16, len(anmf), name), name, seconds)
        if px.shape[:2] != (fh, fw) or x + fw > cw or y + fh > ch:
            raise ValueError(f"{name}: an ANMF frame outside its canvas")
        canvas[y:y + fh, x:x + fw] = px
    else:
        px = _frame([c for c in chunks if c[0] in (b"ALPH", b"VP8 ", b"VP8L")],
                    name, seconds)
        if px.shape[:2] != (ch, cw):
            raise ValueError(f"{name}: the image differs from its canvas")
        canvas = px
    return (canvas, mode) if mode == "RGBA" else (canvas[..., :3], mode)
