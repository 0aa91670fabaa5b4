"""PIL's ``Image.resize(size, Image.LANCZOS)`` on 8-bit images, in numpy.

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
    left as is where alpha is 0 or 255).
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


def _coeffs(in_size: int, out_size: int):
    """``(xmin (out,), taps (out, k) int64 index, weights (out, k) int64)``
    of one pass; taps past a pixel's window have weight 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    taps = np.zeros((out_size, ksize), np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) / filterscale)
             for x in range(xmax)]
        ww = sum(k)
        for x, w in enumerate(k):
            w = w / ww if ww != 0.0 else w
            v = w * (1 << _PRECISION_BITS)
            weights[xx, x] = int(v - 0.5) if w < 0 else int(v + 0.5)
            taps[xx, x] = xmin + x
        taps[xx, xmax:] = xmin  # weight 0
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
