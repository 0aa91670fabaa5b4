"""PIL's ``ImageFilter.GaussianBlur(radius)`` on 8-bit images, in numpy.

The shadow loaders pre-blur their targets with it
(``nerf_pl_tpu/data/shadow_common.py:57``) and the card's machine has no PIL.
This repeats Pillow's algorithm step for step (``libImaging/BoxBlur.c``):

  * the radius becomes an extended box's (Gwosdek et al., SSVM 2011):
    ``sigma2 = r*r / 3``, ``L = sqrt(12 sigma2 + 1)``, ``l = floor((L-1)/2)``,
    ``a = (2l+1)(l(l+1) - 3 sigma2) / (6 (sigma2 - (l+1)^2))``, box radius
    ``l + a``, in C ``float`` where Pillow computes in ``float``;
  * three horizontal passes, then three vertical ones, each rounded to 8 bits:
    per pixel ``ww * (the 2*int(radius)+1 pixels of the box) + fw * (the two
    pixels just outside it)``, indices clamped to the image, with
    ``ww = 2^24 / (2 radius + 1)`` truncated and
    ``fw = (2^24 - (2 int(radius) + 1) ww) / 2``, then ``(sum + 2^23) >> 24``;
  * every channel alone, alpha included (no premultiplication), and a radius
    of 0 returns the image as it is.
"""
from __future__ import annotations

import math

import numpy as np

_PASSES = 3


def _box_radius(radius: float) -> float:
    """Pillow's ``ImagingGaussianBlur`` radius arithmetic (float32 where the
    C source uses ``float``, float64 where it calls ``sqrt``/``floor``)."""
    f = np.float32
    r = f(radius)
    sigma2 = f(r * r) / f(_PASSES)
    L = f(math.sqrt(12.0 * float(sigma2) + 1.0))
    l = f(math.floor((float(L) - 1.0) / 2.0))
    a = (f(2) * l + f(1)) * (l * (l + f(1)) - f(3) * sigma2)
    a = a / (f(6) * (sigma2 - (l + f(1)) * (l + f(1))))
    return float(l + a)


def _box_pass(img: np.ndarray, radius: float) -> np.ndarray:
    """One ``ImagingHorizontalBoxBlur`` along axis 1 of an (H, W, C) image."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / (np.float32(radius) * np.float32(2)
                                    + np.float32(1)))
    fw = ((1 << 24) - (r * 2 + 1) * ww) // 2
    w = img.shape[1]
    src = img.astype(np.int64)
    acc = np.zeros(img.shape, np.int64)
    x = np.arange(w)
    for k in range(-r, r + 1):
        acc += src[:, np.clip(x + k, 0, w - 1)]
    far = src[:, np.clip(x - r - 1, 0, w - 1)] + src[:, np.clip(x + r + 1, 0, w - 1)]
    return ((acc * ww + far * fw + (1 << 23)) >> 24).astype(np.uint8)


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """``img`` (H, W[, C]) uint8 blurred as PIL's ``GaussianBlur(radius)``."""
    if img.dtype != np.uint8:
        raise ValueError(f"gaussian_blur takes uint8, got {img.dtype}")
    if radius == 0:
        return img.copy()
    gray = img.ndim == 2
    out = img[..., None] if gray else img
    box = _box_radius(radius)
    if box != 0:
        for _ in range(_PASSES):
            out = _box_pass(out, box)
        out = out.transpose(1, 0, 2)
        for _ in range(_PASSES):
            out = _box_pass(out, box)
        out = np.ascontiguousarray(out.transpose(1, 0, 2))
    return out[..., 0] if gray else out
