"""Pillow's image semantics on the port's own readers, for every loader.

The JAX loaders read each image through Pillow: ``Image.open`` (which tells
a PNG from a JPEG by its first bytes, whatever the file's name), then
``resize(..., LANCZOS)``, ``filter(GaussianBlur(r))`` and ``convert(mode)``
in the file's own mode.  ``read_picture`` opens a file by its content
(``data/png.py`` or ``data/jpeg.py``) into a ``Picture`` that carries
Pillow's mode and what its ``info`` keeps (a palette, the ``tRNS``
transparency); ``resize``, ``gaussian_blur`` and ``convert`` then do what
Pillow does in that mode:

  * ``resize``: NEAREST for ``1`` and ``P`` (``ImagingScaleAffine``: the
    source column of output ``x`` is ``int(x0)`` for ``x0`` stepped by the
    scale in doubles from half a step); LANCZOS in 8 bits for ``L``,
    ``RGB`` and ``CMYK``, premultiplied for ``LA`` and ``RGBA``
    and in 16 bits for ``I;16`` (``data/resize.py``); the transparency is
    kept, as ``Image._new`` keeps ``info``;
  * ``gaussian_blur``: ``data/blur.py`` on ``L``, ``LA``, ``RGB``,
    ``RGBA`` and ``CMYK``; any other mode raises as Pillow's
    ``image has wrong mode``;
  * ``convert`` to ``L``, ``RGB`` or ``RGBA`` from every mode the readers
    give: ``I;16`` clipped at 255, ``P`` through its palette (entries past
    the file's black) with the ``tRNS`` alphas, a key colour (``1``, ``L``,
    ``I;16`` clipped first, ``RGB``) made transparent in ``RGBA``, ``CMYK``
    as ``cmyk2rgb`` (``255 - k - (c (255 - k) / 255)``, rounded as
    ``MULDIV255``), luma in PIL's fixed point.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import jpeg, png
from .blur import gaussian_blur as _blur
from .resize import resize_lanczos, resize_lanczos_16

_PNG = b"\x89PNG\r\n\x1a\n"


class Picture:
    """An image as Pillow holds it: ``pixels`` (H, W[, C]) (uint16 for
    ``I;16``, palette indices for ``P``), ``mode``, and the ``palette``
    ((n, 3) uint8) and ``transparency`` (an int, a tuple or bytes) of its
    ``info``."""

    def __init__(self, pixels: np.ndarray, mode: str,
                 palette: Optional[np.ndarray] = None, transparency=None):
        self.pixels, self.mode = pixels, mode
        self.palette, self.transparency = palette, transparency

    def _with(self, pixels: np.ndarray) -> "Picture":
        return Picture(pixels, self.mode, self.palette, self.transparency)


def read_picture(path: str) -> Picture:
    """Open ``path`` by its content, as ``Image.open`` does."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG:
        return Picture(*png.decode_png(data, path))
    if data[:2] == b"\xff\xd8":
        try:
            return Picture(*jpeg.decode(data))
        except jpeg._Unsupported as e:
            raise ValueError(f"{path}: unsupported JPEG: {e}") from None
    raise ValueError(f"{path}: neither a PNG nor a JPEG file (it starts "
                     f"{data[:8]!r})")


# ------------------------------------------------------------- resize
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """``ImagingScaleAffine``'s source index of each output column."""
    step = in_size / out_size
    x, out = step * 0.5, []
    for _ in range(out_size):
        out.append(min(int(x), in_size - 1))
        x += step
    return np.array(out, np.int64)


def resize(pic: Picture, size) -> Picture:
    """``Image.resize(size, Image.LANCZOS)`` in the picture's mode."""
    w, h = (int(v) for v in size)
    if w < 1 or h < 1:
        raise ValueError(f"cannot resize to {size}")
    px = pic.pixels
    if (px.shape[1], px.shape[0]) == (w, h):
        return pic._with(px.copy())
    if pic.mode in ("1", "P"):
        rows = _nearest_index(px.shape[0], h)
        cols = _nearest_index(px.shape[1], w)
        return pic._with(px[rows][:, cols])
    if pic.mode == "I;16":
        return pic._with(resize_lanczos_16(px, (w, h)))
    return pic._with(resize_lanczos(px, pic.mode, (w, h)))


def gaussian_blur(pic: Picture, radius: float) -> Picture:
    """``Image.filter(ImageFilter.GaussianBlur(radius))``."""
    if pic.mode not in ("L", "LA", "RGB", "RGBA", "CMYK"):
        raise ValueError(f"image has wrong mode ({pic.mode!r}: Pillow's "
                         "GaussianBlur refuses it)")
    return pic._with(_blur(pic.pixels, radius))


# ------------------------------------------------------------ convert
def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's ``rgb2l``: ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``."""
    rgb = rgb.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _muldiv255(a, b):
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def _cmyk_to_rgb(px: np.ndarray) -> np.ndarray:
    c = px.astype(np.int32)
    nk = 255 - c[..., 3:]
    return np.clip(nk - _muldiv255(c[..., :3], nk), 0, 255).astype(np.uint8)


def _palette(pic: Picture) -> np.ndarray:
    """The 256-entry palette as Pillow realises it: the file's entries, then
    black."""
    pal = np.zeros((256, 3), np.uint8)
    n = min(len(pic.palette), 256)
    pal[:n] = pic.palette[:n]
    return pal


def _key_alpha(pic: Picture, values: np.ndarray) -> np.ndarray:
    """Alpha 0 where the pixel equals the transparency key, else 255."""
    t = pic.transparency
    if t is None:
        return np.full(values.shape[:2], 255, np.uint8)
    if values.ndim == 3:
        hit = (values == np.array(t)[None, None, :]).all(-1)
    else:
        hit = values == t
    return np.where(hit, 0, 255).astype(np.uint8)


def _rgb(pic: Picture) -> np.ndarray:
    px, mode = pic.pixels, pic.mode
    if mode == "RGB":
        return px
    if mode == "RGBA":
        return px[..., :3]
    if mode == "P":
        return _palette(pic)[px]
    if mode == "CMYK":
        return _cmyk_to_rgb(px)
    return np.repeat(_gray(pic)[..., None], 3, -1)


def _gray(pic: Picture) -> np.ndarray:
    px, mode = pic.pixels, pic.mode
    if mode in ("L", "1"):
        return px
    if mode == "I;16":
        return np.minimum(px, 255).astype(np.uint8)
    if mode == "LA":
        return px[..., 0]
    return _luma(_rgb(pic))


def convert(pic: Picture, mode: str) -> np.ndarray:
    """``np.asarray(Image.convert(mode))`` for ``mode`` ``L``, ``RGB`` or
    ``RGBA``."""
    if mode == "L":
        return _gray(pic)
    if mode == "RGB":
        return _rgb(pic)
    if mode != "RGBA":
        raise ValueError(f"cannot convert to {mode!r}")
    src = pic.mode
    if src == "RGBA":
        return pic.pixels
    rgb = _rgb(pic)
    if src == "LA":
        alpha = pic.pixels[..., 1]
    elif src == "P":
        alpha = np.full(256, 255, np.uint8)
        t = pic.transparency
        if isinstance(t, bytes):
            n = min(len(t), 256)
            alpha[:n] = np.frombuffer(t[:n], np.uint8)
        elif t is not None:
            alpha[t] = 0
        alpha = alpha[pic.pixels]
    elif src == "RGB":
        alpha = _key_alpha(pic, pic.pixels)
    elif src in ("1", "L", "I;16"):  # the key against the 8-bit values
        alpha = _key_alpha(pic, _gray(pic))
    else:  # CMYK
        alpha = np.full(rgb.shape[:2], 255, np.uint8)
    return np.concatenate([rgb, alpha[..., None]], -1)
