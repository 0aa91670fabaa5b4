"""ctypes bindings of ``csrc/rle_decode.cpp``: the byte-stream stages of the
TGA, PCX, SGI, QOI, SUN, MSP, FLI and ICNS readers (``data/tga.py``,
``data/pcx.py``, ``data/sgi.py``, ``data/qoi.py``, ``data/sun.py``,
``data/msp.py``, ``data/fli.py``, ``data/icns.py``), which the loaders
call.  Each of those
modules keeps the same stage in plain Python (``*_plain``), which the tests
hold the C++ against.  The library is built with g++ at first use through
``data/native.py``; a failed build raises, naming the source.

Each call returns the decoded bytes, or raises ``ValueError`` with
Pillow's reading of the fault: ``image file is truncated`` where the data
ends first, ``buffer overrun`` where a run reaches past a row.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from . import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "rle_decode.cpp"
ERRORS = {-1: "image file is truncated",
          -2: "buffer overrun when reading image file"}

_lock = threading.Lock()
_lib = None


def _native():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SOURCE)))
            i64, i32, vp = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
            lib.tga_rle.restype = ctypes.c_int
            lib.tga_rle.argtypes = [ctypes.c_char_p, i64, i32, i32, i32, vp]
            lib.pcx_rle.restype = ctypes.c_int
            lib.pcx_rle.argtypes = [ctypes.c_char_p, i64, i64, i32, vp]
            lib.sgi_rle.restype = ctypes.c_int
            lib.sgi_rle.argtypes = [ctypes.c_char_p, i64, i32, i32, i32, i32,
                                    vp, vp, vp]
            lib.qoi_decode.restype = ctypes.c_int
            lib.qoi_decode.argtypes = [ctypes.c_char_p, i64, i64, vp]
            lib.sun_rle.restype = ctypes.c_int
            lib.sun_rle.argtypes = [ctypes.c_char_p, i64, i64, i32, vp]
            lib.msp_rows.restype = i64
            lib.msp_rows.argtypes = [ctypes.c_char_p, i64, i32, i32, i64, vp]
            lib.fli_frame.restype = ctypes.c_int
            lib.fli_frame.argtypes = [ctypes.c_char_p, i64, i32, i32, vp]
            lib.icns_rgb.restype = ctypes.c_int
            lib.icns_rgb.argtypes = [ctypes.c_char_p, i64, i64, vp]
            _lib = lib
        return _lib


def _check(rc: int) -> None:
    if rc != 0:
        raise ValueError(ERRORS.get(rc, f"decoder error {rc}"))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def tga_rle(data: bytes, w: int, h: int, depth: int) -> np.ndarray:
    """TGA run-length packets -> (h, w * depth) bytes in file order."""
    out = np.zeros((h, w * depth), np.uint8)
    _check(_native().tga_rle(data, len(data), w, h, depth, _ptr(out)))
    return out


def pcx_rle(data: bytes, row_bytes: int, h: int) -> np.ndarray:
    """PCX runs -> (h, row_bytes) bytes."""
    out = np.zeros((h, row_bytes), np.uint8)
    _check(_native().pcx_rle(data, len(data), row_bytes, h, _ptr(out)))
    return out


def sgi_rle(data: bytes, xsize: int, ysize: int, zsize: int, bpc: int,
            starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """SGI rows (``starts``/``lengths`` of each channel's rows, offsets in
    the whole file ``data``) -> (ysize, xsize * zsize * bpc) bytes, rows in
    file order, channels interleaved."""
    out = np.zeros((ysize, xsize * zsize * bpc), np.uint8)
    st = np.ascontiguousarray(starts, np.uint32)
    ln = np.ascontiguousarray(lengths, np.uint32)
    _check(_native().sgi_rle(data, len(data), xsize, ysize, zsize, bpc,
                             _ptr(st), _ptr(ln), _ptr(out)))
    return out


def qoi(data: bytes, npix: int) -> np.ndarray:
    """A QOI op stream -> (npix, 4) RGBA."""
    out = np.zeros((npix, 4), np.uint8)
    _check(_native().qoi_decode(data, len(data), npix, _ptr(out)))
    return out


def sun_rle(data: bytes, row_bytes: int, h: int) -> np.ndarray:
    """SUN runs -> (h, row_bytes) bytes."""
    out = np.zeros((h, row_bytes), np.uint8)
    _check(_native().sun_rle(data, len(data), row_bytes, h, _ptr(out)))
    return out


MSP_ERRORS = {-1: "Truncated MSP file in row map",
              -3: "Truncated MSP file in a row", -4: "Corrupted MSP file"}


def msp_rows(data: bytes, w: int, h: int, cap: int) -> tuple:
    """MSP v2's rows of the whole file ``data`` -> (their first ``cap``
    joined bytes, the count of all)."""
    out = np.zeros(cap, np.uint8)
    n = _native().msp_rows(data, len(data), w, h, cap, _ptr(out))
    if n < 0:
        raise ValueError(MSP_ERRORS[n])
    return out[:min(n, cap)].tobytes(), n


FLI_ERRORS = {-1: "image file is truncated",
              -2: "buffer overrun when reading image file",
              -3: "unrecognized data stream contents when reading image file",
              -4: "broken data stream when reading image file"}


def fli_frame(buf: bytes, w: int, h: int) -> np.ndarray:
    """One FLI frame chunk -> (h, w) P indices."""
    out = np.zeros((h, w), np.uint8)
    rc = _native().fli_frame(buf, len(buf), w, h, _ptr(out))
    if rc:
        raise ValueError(FLI_ERRORS[rc])
    return out


ICNS_ERRORS = {-1: "not enough image data",
               -2: "Error reading channel"}


def icns_rgb(data: bytes, npix: int) -> np.ndarray:
    """ICNS's three run-length channels -> (3, npix) bytes."""
    out = np.zeros((3, npix), np.uint8)
    rc = _native().icns_rgb(data, len(data), npix, _ptr(out))
    if rc:
        raise ValueError(ICNS_ERRORS[rc])
    return out
