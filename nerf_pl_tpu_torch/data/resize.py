"""PIL's ``Image.resize(size, Image.LANCZOS)`` on 8- and 16-bit images, in
numpy.

The card's machine has no PIL, and the Blender loader resizes its PNGs to
``--img_wh`` (``nerf_pl_tpu/data/blender.py:37``).  This repeats Pillow's
algorithm step for step (``libImaging/Resample.c``):

  * a Lanczos-3 filter, its support stretched by the scale factor when
    downscaling; per output pixel the taps ``[xmin, xmin + n)`` and their
    double weights, normalised to sum 1, then made fixed point with 22
    fractional bits (rounded half away from zero);
  * two separable passes, horizontal then vertical, each summing
    ``2^21 + sum(pixel * weight)`` in integers and keeping bits 22 and up,
    clipped to ``[0, 255]``; a pass whose size does not change is skipped;
  * images with alpha (``RGBA``, ``LA``) are resized premultiplied: Pillow
    converts to ``RGBa`` / ``La`` (``c * a / 255``, rounded as ``MULDIV255``),
    resizes, and converts back (``255 * c / a``, truncated and clipped, and
    left as is where alpha is 0 or 255);
  * ``I;16`` images take ``Resample.c``'s ``_16bpc`` passes instead: the
    normalised double weights summed in doubles in tap order, ``ROUND_UP``
    (half away from zero), then each byte of the result clipped on its own
    (``CLIP8(v % 256)``, ``CLIP8(v >> 8)``, C's remainder).  Pillow reads
    and writes an ``I;16B`` image's two bytes in the little-endian order
    there (``Resample.c`` takes big-endian order only for ``I;16N`` on a
    big-endian host), so its samples are resized byte-swapped;
  * ``I`` and ``F`` images take the ``_32bpc`` passes: the same double
    sums, an ``I`` result rounded by ``ROUND_UP`` into an int32, an ``F``
    result stored as float32.
"""
from __future__ import annotations

import math

import numpy as np

_SUPPORT = 3.0  # Lanczos-3
_PRECISION_BITS = 32 - 8 - 2


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x *= math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -_SUPPORT <= x < _SUPPORT:
        return _sinc(x) * _sinc(x / _SUPPORT)
    return 0.0


def _coeffs_double(in_size: int, out_size: int):
    """``precompute_coeffs``: per output pixel its first tap and its double
    weights, normalised to sum 1."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ss = 1.0 / filterscale
    out = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:  # in order, as C adds (Python's sum() compensates)
            ww += w
        out.append((xmin, [w / ww if ww != 0.0 else w for w in k]))
    return out


def _coeffs(in_size: int, out_size: int):
    """``(taps (out, k) int64 index, weights (out, k) int64)`` of one 8-bit
    pass: the double weights in 22-bit fixed point, rounded half away from
    zero; taps past a pixel's window have weight 0."""
    double = _coeffs_double(in_size, out_size)
    ksize = int(math.ceil(_SUPPORT * max(in_size / out_size, 1.0))) * 2 + 1
    taps = np.zeros((out_size, ksize), np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx, (xmin, k) in enumerate(double):
        for x, w in enumerate(k):
            v = w * (1 << _PRECISION_BITS)
            weights[xx, x] = int(v - 0.5) if w < 0 else int(v + 0.5)
            taps[xx, x] = xmin + x
        taps[xx, len(k):] = xmin  # weight 0
    return taps, weights


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One fixed-point pass along ``axis`` of an (H, W, C) uint8 image."""
    taps, weights = _coeffs(img.shape[axis], out_size)
    src = img.astype(np.int64)
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(taps.shape[1]):
        w = weights[:, j]
        if not w.any():
            continue
        picked = np.take(src, taps[:, j], axis=axis)
        shape = [1, 1, 1]
        shape[axis] = out_size
        acc += picked * w.reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _premultiply(img: np.ndarray) -> np.ndarray:
    out = img.copy()
    a = img[..., -1:].astype(np.uint32)
    t = img[..., :-1].astype(np.uint32) * a + 128
    out[..., :-1] = ((t >> 8) + t) >> 8
    return out


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    out = img.copy()
    a = img[..., -1:].astype(np.int64)
    c = img[..., :-1].astype(np.int64)
    back = np.clip(255 * c // np.maximum(a, 1), 0, 255)
    keep = (a == 0) | (a == 255)
    out[..., :-1] = np.where(keep, c, back).astype(np.uint8)
    return out


def resize_lanczos(img: np.ndarray, mode: str, size) -> np.ndarray:
    """``img`` (H, W[, C]) uint8 in PIL ``mode`` (``L``, ``LA``, ``RGB`` or
    ``RGBA``) resized to ``size = (w, h)`` as PIL's ``LANCZOS`` does."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_lanczos takes uint8, got {img.dtype}")
    w, h = (int(v) for v in size)
    if w < 1 or h < 1:
        raise ValueError(f"cannot resize to {size}")
    if (img.shape[1], img.shape[0]) == (w, h):
        return img.copy()  # PIL returns a copy without resampling
    gray = img.ndim == 2
    out = img[..., None] if gray else img
    alpha = mode in ("LA", "RGBA")
    if alpha:
        out = _premultiply(out)
    if out.shape[1] != w:
        out = _pass(out, w, axis=1)
    if out.shape[0] != h:
        out = _pass(out, h, axis=0)
    if alpha:
        out = _unpremultiply(out)
    return out[..., 0] if gray else out


def _sums(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """A pass's double sums along ``axis``, in the C loop's tap order."""
    src = np.moveaxis(img.astype(np.float64), axis, 0)
    coeffs = _coeffs_double(src.shape[0], out_size)
    ksize = max(len(k) for _, k in coeffs)
    acc = np.zeros((out_size,) + src.shape[1:], np.float64)
    for j in range(ksize):  # the C loop's order; a tap past xmax adds 0.0
        idx = np.array([xmin + min(j, len(k) - 1) for xmin, k in coeffs])
        w = np.array([k[j] if j < len(k) else 0.0 for _, k in coeffs])
        acc += src[idx] * w.reshape((-1,) + (1,) * (src.ndim - 1))
    return np.moveaxis(acc, 0, axis)


def _round_up(acc: np.ndarray) -> np.ndarray:
    """``ROUND_UP``: half away from zero, then C's truncation."""
    return np.where(acc >= 0.0, np.floor(acc + 0.5),
                    -np.floor(np.abs(acc) + 0.5)).astype(np.int64)


def _pass_16(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One ``ImagingResample*_16bpc`` pass along ``axis`` of (H, W) uint16."""
    ss = _round_up(_sums(img, out_size, axis))
    lo = np.clip(np.fmod(ss, 256), 0, 255)
    hi = np.clip(ss >> 8, 0, 255)
    return (hi * 256 + lo).astype(np.uint16)


def resize_lanczos_16(img: np.ndarray, size, big_endian: bool = False
                      ) -> np.ndarray:
    """A (H, W) ``I;16`` (or ``I;16B``) image of uint16 values resized to
    ``size = (w, h)`` as PIL's ``LANCZOS`` does in that mode."""
    w, h = (int(v) for v in size)
    out = img.byteswap() if big_endian else img
    if out.shape[1] != w:
        out = _pass_16(out, w, 1)
    if out.shape[0] != h:
        out = _pass_16(out, h, 0)
    return out.byteswap() if big_endian else out


def resize_lanczos_32(img: np.ndarray, mode: str, size) -> np.ndarray:
    """A (H, W) ``I`` (int32) or ``F`` (float32) image resized to
    ``size = (w, h)`` as PIL's ``LANCZOS`` does in that mode."""
    w, h = (int(v) for v in size)
    out = img
    for n, axis in ((w, 1), (h, 0)):
        if out.shape[axis] == n:
            continue
        acc = _sums(out, n, axis)
        if mode == "I":  # C's cast of a double past int32: INT_MIN on x86
            r = _round_up(acc)
            out = np.where((r > 2 ** 31 - 1) | (r < -2 ** 31), -2 ** 31,
                           r).astype(np.int32)
        else:
            out = acc.astype(np.float32)
    return out
