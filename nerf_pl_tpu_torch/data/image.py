"""Pillow's image semantics on the port's own readers, for every loader.

The JAX loaders read each image through Pillow: ``Image.open`` (which tells
the container by its content, whatever the file's name), then
``resize(..., LANCZOS)``, ``filter(GaussianBlur(r))`` and ``convert(mode)``
in the file's own mode.  ``read_picture`` opens a file as ``Image.open``
does: it walks Pillow's formats in ``Image.ID``'s order (the pre-init
plugins, then the rest as ``Image.init`` registers them; ``_FORMATS``),
asks each whether it accepts the first 16 bytes, then opens it; a
``SyntaxError``, IndexError, TypeError or ``struct.error`` in the open
moves on to the next format, anything else raises, as in
``Image._open_core`` (the formats read since the rest of ``Image.ID`` came
also move on from a ``KeyError``, an ``EOFError`` or no mode, as
``ImageFile.__init__`` does; ``_plugin``).  The port reads PNG
(``data/png.py``), JPEG (``data/jpeg.py``), WebP (``data/webp.py``), TIFF
(``data/tiff.py``), PPM/PGM/PBM/PFM (``data/ppm.py``), BMP and DIB
(``data/bmp.py``), GIF (``data/gif.py``), ICO and CUR (``data/ico.py``),
PCX (``data/pcx.py``), DDS (``data/dds.py``), JPEG 2000
(``data/jpeg2000.py``), PSD (``data/psd.py``), QOI (``data/qoi.py``), SGI
(``data/sgi.py``), BLP, DCX, FITS, FLI, FTEX, GBR, ICNS, IPTC, MCIDAS,
MSP, PCD, PIXAR, SPIDER, SUN, XBM, XPM and XVTHUMB (``data/<format>.py``),
IM and IMT (``data/im.py``) and TGA (``data/tga.py``, which has no magic
number and comes after most others), each into a ``Picture`` that carries
Pillow's mode and what its ``info`` keeps (a palette, the transparency).
A file that another of Pillow's formats would claim (AVIF, BUFR, EPS,
GRIB, HDF5, MPEG, WMF) raises, naming that format.
``resize``, ``gaussian_blur`` and ``convert`` then do what Pillow does in
that mode:

  * ``resize``: NEAREST for ``1`` and ``P`` (``ImagingScaleAffine``: the
    source column of output ``x`` is ``int(x0)`` for ``x0`` stepped by the
    scale in doubles from half a step); LANCZOS in 8 bits for ``L``,
    ``RGB``, ``CMYK``, ``YCbCr``, ``PA`` and ``LAB``, premultiplied for
    ``LA`` and ``RGBA``, in 16 bits for ``I;16``, ``I;16L`` and ``I;16B``
    (the latter's bytes swapped, as Pillow reads them) and in doubles for
    ``I`` and ``F`` (``data/resize.py``); the transparency is kept, as
    ``Image._new`` keeps ``info``, but a resampled ``PA`` image loses its
    palette (its new core image has an empty one: black); an ICNS resizes
    as Pillow's image was before its load (``Picture.opened``);
  * ``gaussian_blur``: ``data/blur.py`` on ``L``, ``LA``, ``RGB``,
    ``RGBA`` and ``CMYK``; any other mode raises as Pillow's
    ``image has wrong mode``;
  * ``convert`` to ``L``, ``RGB`` or ``RGBA`` from every mode the readers
    give: ``I;16``, ``I;16L``, ``I;16B`` and ``I`` clipped to 0-255,
    ``YCbCr`` through Pillow's tables (``jpeg2000.ycc_to_rgb``; its ``Y``
    band to ``L``), ``F`` clipped and
    truncated, ``P`` and ``PA`` through the palette (entries past the
    file's black) with the ``tRNS`` alphas or the ``A`` band, a key colour
    (``1``, ``L``, ``I;16`` clipped first, ``RGB``) made transparent in
    ``RGBA``, ``CMYK`` as ``cmyk2rgb`` (``255 - k - (c (255 - k) / 255)``,
    rounded as ``MULDIV255``), luma in PIL's fixed point, ``LAB`` to
    ``RGB`` and ``RGBA`` (alpha: ``Picture.pad``) as LittleCMS converts it
    for Pillow (``data/lcms.py``).  ``LAB`` to ``L`` raises, as in Pillow.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from . import (blp, bmp, dcx, dds, fits, fli, ftex, gbr, gif, icns, ico, im,
               iptc, jpeg, jpeg2000, lcms, mcidas, msp, pcd, pcx, pixar, png,
               ppm, psd, qoi, sgi, spider, sun, tga, tiff, webp, xbm, xpm,
               xvthumb)
from .blur import gaussian_blur as _blur
from .resize import resize_lanczos, resize_lanczos_16, resize_lanczos_32

_PNG = b"\x89PNG\r\n\x1a\n"
_TIFF = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
         b"MM\x00\x2b", b"II\x2b\x00")  # TiffImagePlugin.PREFIXES


# a LAB picture's pixels are Pillow's array (a and b signed, as its packer
# gives them); its core image, which LittleCMS and the resampler read, holds
# a and b offset by 128
_LAB_CORE = np.array([0, 128, 128], np.uint8)


class Picture:
    """An image as Pillow holds it: ``pixels`` (H, W[, C]) (uint16 values
    for ``I;16`` and ``I;16B``, int32 for ``I``, float32 for ``F``, palette
    indices for ``P`` and ``PA``), ``mode``, and the ``palette`` ((n, 3)
    uint8) and ``transparency`` (an int, a tuple or bytes: per-entry alphas
    of a palette) of its ``info``.  An ``L`` or ``LA`` picture with a
    palette is a TGA whose core image Pillow made ``P`` or ``PA``.
    ``opened`` is the (mode, size) Pillow's image has before its load
    where those differ from the loaded ones' (an ICNS: ``RGBA`` and the
    icon's size, whatever its payload).  ``pad`` is the fourth byte of
    the core image's pixels in ``LAB`` (255 where Pillow's ``LAB`` unpacker
    filled them, 0 where its bands were read one by one or resampled), which
    Pillow's transform copies into ``RGBA``'s alpha.  ``core`` holds the
    core image's pixels where Pillow's array shows them at another size
    (an IPTC file whose header's size is not its image data's): ``convert``
    and ``resize`` work on it."""

    def __init__(self, pixels: np.ndarray, mode: str,
                 palette: Optional[np.ndarray] = None, transparency=None,
                 name: str = "image", opened: Optional[tuple] = None,
                 pad: int = 0, core: Optional[np.ndarray] = None):
        self.pixels, self.mode = pixels, mode
        self.palette, self.transparency = palette, transparency
        self.name = name  # the file it was read from, for errors
        self.opened = opened
        self.pad = pad
        self.core = core

    def _with(self, pixels: np.ndarray) -> "Picture":
        return Picture(pixels, self.mode, self.palette, self.transparency,
                       self.name, self.opened, self.pad)


def read_picture(path: str) -> Picture:
    """Open ``path`` by its content, as ``Image.open`` does."""
    pic = _read(path)
    pic.name = path
    return pic


# Image.MAX_IMAGE_PIXELS: Image.open raises DecompressionBombError past twice it
_BOMB_PIXELS = 2 * 178956970
_NEXT = (SyntaxError, IndexError, TypeError, struct.error)


def _now(decode):
    """An opener without a header stage, for the containers the port read
    before it walked ``Image.ID``: their faults raise, as before."""
    return lambda data, path: (None, lambda: decode(data, path))


def _jpeg(data, path):
    try:
        return jpeg.decode(data)
    except jpeg._Unsupported as e:
        raise ValueError(f"{path}: unsupported JPEG: {e}") from None


def _opened(open_fn, load_fn):
    """An opener of a header (``open_fn``, whose faults may move on) and
    its pixels (``load_fn``, whose faults raise)."""
    def opener(data, path):
        head = open_fn(data)
        return head["size"], lambda: load_fn(data, head)
    return opener


def _dib(data, path):
    return None, lambda: bmp.decode_dib(data, path)[:4]


def _decoded(decode):
    """A format Pillow decodes in its open (ICO), or whose open reads the
    whole header (CUR): its faults in the header move on."""
    def opener(data, path):
        out = decode(data, path)
        return (out[0].shape[1], out[0].shape[0]), lambda: out
    return opener


def _i32(prefix: bytes, big: bool = False) -> int:
    return struct.unpack(">I" if big else "<I", prefix[:4])[0]


def _jpeg2000(data, path):
    """``Jpeg2KImageFile._open``: its assertion (no ``jp2h``) and short
    reads raise in ``Image.open``, as here."""
    try:
        return _opened(jpeg2000.open_jpeg2000, jpeg2000.load_jpeg2000)(data,
                                                                      path)
    except (AssertionError, OSError) as e:
        raise ValueError(f"{path}: JPEG2000: {str(e) or 'no jp2h box'}"
                         ) from None


def _not_read(name: str):
    def opener(data, path):
        raise ValueError(f"{path}: Pillow reads this as {name}, a format "
                         "the port does not read")
    return opener


# ImageFile.__init__ turns these faults of a plugin's _open into SyntaxError
_MOVE_ON = (KeyError, EOFError)


def _plugin(open_fn, load_fn):
    """An opener of one of the formats that came with ``Image.ID``'s walk:
    faults of its open move on or raise as in ``ImageFile.__init__`` (no
    mode moves on, as there); its load raises ``ValueError``."""
    def opener(data, path):
        try:
            head = open_fn(data)
        except _MOVE_ON as e:
            raise SyntaxError(str(e)) from None
        except (OSError, OverflowError) as e:  # FITS' cut header, SPIDER's inf
            raise ValueError(str(e) or type(e).__name__) from None
        if not head["mode"]:
            raise SyntaxError("no mode: not this format")
        head["path"] = path
        return head["size"], lambda: load_fn(data, head)
    return opener


_AVIF_BRANDS = (b"avif", b"avis", b"mif1", b"msf1")
_FORMATS = (  # (name, accept, opener) in Image.ID's order
    ("BMP", lambda p: p[:2] == b"BM", _now(bmp.decode)),
    ("DIB", lambda p: _i32(p) in (12, 40, 52, 56, 64, 108, 124), _dib),
    ("GIF", lambda p: p[:6] in (b"GIF87a", b"GIF89a"), _now(gif.decode)),
    ("JPEG", lambda p: p[:3] == b"\xff\xd8\xff", _now(_jpeg)),
    ("PPM", lambda p: p[:1] == b"P" and p[1:2] != b"" and p[1] in
     b"0123456fy", _now(ppm.decode)),
    ("PNG", lambda p: p[:8] == _PNG, _now(png.decode_png)),
    ("AVIF", lambda p: p[4:8] == b"ftyp" and p[8:12] in _AVIF_BRANDS,
     _not_read("AVIF")),
    ("BLP", lambda p: p[:4] in (b"BLP1", b"BLP2"),
     _plugin(blp.open_blp, blp.load_blp)),
    ("BUFR", lambda p: p[:4] in (b"BUFR", b"ZCZC"), _not_read("BUFR")),
    ("CUR", lambda p: p[:4] == b"\0\0\2\0", _decoded(ico.decode_cur)),
    ("PCX", pcx._accept, _opened(pcx.open_pcx, pcx.load_pcx)),
    ("DCX", lambda p: len(p) >= 4 and _i32(p) == 0x3ADE68B1,
     _plugin(dcx.open_dcx, dcx.load_dcx)),
    ("DDS", lambda p: p[:4] == b"DDS ", _opened(dds.open_dds, dds.load_dds)),
    ("EPS", lambda p: p[:4] == b"%!PS" or _i32(p) == 0xC6D3D0C5,
     _not_read("EPS")),
    ("FITS", lambda p: p[:6] == b"SIMPLE", _plugin(fits.open_fits,
                                                   fits.load_fits)),
    ("FLI", lambda p: len(p) >= 16 and struct.unpack_from("<H", p, 4)[0] in (
        0xAF11, 0xAF12) and struct.unpack_from("<H", p, 14)[0] in (0, 3),
     _plugin(fli.open_fli, fli.load_fli)),
    ("FTEX", lambda p: p[:4] == b"FTEX", _plugin(ftex.open_ftex,
                                                 ftex.load_ftex)),
    ("GBR", lambda p: len(p) >= 8 and _i32(p, True) >= 20 and _i32(
        p[4:], True) in (1, 2), _plugin(gbr.open_gbr, gbr.load_gbr)),
    ("GRIB", lambda p: len(p) >= 8 and p[:4] == b"GRIB" and p[7] == 1,
     _not_read("GRIB")),
    ("HDF5", lambda p: p[:8] == b"\x89HDF\r\n\x1a\n", _not_read("HDF5")),
    ("JPEG2000", jpeg2000.accept, _jpeg2000),
    ("ICNS", lambda p: p[:4] == b"icns", _plugin(icns.open_icns,
                                                 icns.load_icns)),
    ("ICO", lambda p: p[:4] == b"\0\0\1\0", _decoded(ico.decode_ico)),
    ("IM", None, _plugin(im.open_im, im.load_im)),
    ("IMT", None, _plugin(im.open_imt, im.load_imt)),
    ("IPTC", None, _plugin(iptc.open_iptc, iptc.load_iptc)),
    ("MCIDAS", lambda p: p[:8] == b"\0\0\0\0\0\0\0\4",
     _plugin(mcidas.open_mcidas, mcidas.load_mcidas)),
    ("MPEG", lambda p: p[:4] == b"\0\0\1\xb3", _not_read("MPEG")),
    ("TIFF", lambda p: p[:4] in _TIFF, _now(tiff.decode)),
    ("MSP", lambda p: p[:4] in (b"DanM", b"LinS"),
     _plugin(msp.open_msp, msp.load_msp)),
    ("PCD", None, _plugin(pcd.open_pcd, pcd.load_pcd)),
    ("PIXAR", lambda p: p[:4] == b"\200\350\000\000",
     _plugin(pixar.open_pixar, pixar.load_pixar)),
    ("PSD", lambda p: p[:4] == b"8BPS", _opened(psd.open_psd, psd.load_psd)),
    ("QOI", lambda p: p[:4] == b"qoif", _opened(qoi.open_qoi, qoi.load_qoi)),
    ("SGI", lambda p: len(p) >= 2 and p[0] == 1 and p[1] == 0xDA,
     _opened(sgi.open_sgi, sgi.load_sgi)),
    ("SPIDER", None, _plugin(spider.open_spider, spider.load_spider)),
    ("SUN", lambda p: len(p) >= 4 and _i32(p, True) == 0x59A66A95,
     _plugin(sun.open_sun, sun.load_sun)),
    ("TGA", None, _opened(tga.open_tga, tga.load_tga)),
    ("WEBP", lambda p: p[:4] == b"RIFF" and p[8:12] == b"WEBP",
     _now(webp.decode)),
    ("WMF", lambda p: p[:6] == b"\xd7\xcd\xc6\x9a\0\0" or p[:4] ==
     b"\x01\x00\x00\x00", _not_read("WMF")),
    ("XBM", lambda p: p.lstrip().startswith(b"#define"),
     _plugin(xbm.open_xbm, xbm.load_xbm)),
    ("XPM", lambda p: p[:9] == b"/* XPM */", _plugin(xpm.open_xpm,
                                                     xpm.load_xpm)),
    ("XVTHUMB", lambda p: p[:6] == b"P7 332",
     _plugin(xvthumb.open_xvthumb, xvthumb.load_xvthumb)),
)
READS = ("PNG", "JPEG", "WebP", "TIFF", "PPM", "BMP", "DIB", "GIF", "ICO",
         "CUR", "PCX", "DDS", "JPEG2000", "PSD", "QOI", "SGI", "BLP", "DCX",
         "FITS", "FLI", "FTEX", "GBR", "ICNS", "IM", "IMT", "IPTC", "MCIDAS",
         "MSP", "PCD", "PIXAR", "SPIDER", "SUN", "XBM", "XPM", "XVTHUMB",
         "TGA")


def open_format(data: bytes, path: str = "image"):
    """The name of the format ``Image.open`` would give ``data`` and a
    loader of its ``(pixels, mode, palette, transparency)``; raises
    ``ValueError`` where ``Image.open`` raises."""
    prefix = data[:16]
    for name, accept, opener in _FORMATS:
        try:
            if accept is not None and not accept(prefix):
                continue
            size, load = opener(data, path)
        except _NEXT:
            continue
        except ValueError as e:
            if str(e).startswith(f"{path}: "):
                raise
            raise ValueError(f"{path}: {name}: {e}") from None
        if size is not None:
            if size[0] <= 0 or size[1] <= 0:
                continue  # ImageFile refuses a size of 0: the next format
            if size[0] * size[1] > _BOMB_PIXELS:
                raise ValueError(f"{path}: {size[0]}x{size[1]} pixels, past "
                                 "Pillow's decompression bomb limit")
        return name, load
    raise ValueError(f"{path}: not a {', '.join(READS[:-1])} or {READS[-1]} "
                     f"file (it starts {data[:8]!r})")


def _read(path: str) -> Picture:
    with open(path, "rb") as f:
        data = f.read()
    name, load = open_format(data, path)
    try:
        out = load()
        return Picture(*out[:4], opened=out[4] if len(out) > 4 else None,
                       pad=out[5] if len(out) > 5 else 0,
                       core=out[6] if len(out) > 6 else None)
    except ValueError as e:
        if str(e).startswith(path):
            raise
        raise ValueError(f"{path}: {name}: {e}") from None


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
    if pic.core is not None:  # the box of the shown size over the core
        shown = pic.pixels.shape[1], pic.pixels.shape[0]
        if (w, h) == shown:  # Pillow's copy: the core image
            return pic._with(pic.core.copy())
        if shown[0] > pic.core.shape[1] or shown[1] > pic.core.shape[0]:
            raise ValueError("box can't exceed original image size")
        raise ValueError(f"{pic.name}: a resize of part of the image (the "
                         "IPTC header's size inside its image data's) is "
                         "not ported")
    px = pic.pixels
    if pic.opened is not None:  # Pillow's resize looks before the load
        if (w, h) == pic.opened[1]:
            return pic._with(px.copy())
        if pic.opened[0] == "RGBA" and pic.mode not in ("RGB", "RGBA"):
            raise ValueError("conversion not supported" if pic.mode == "P"
                             else "conversion from L to RGBa not supported")
        if pic.opened[1][0] > px.shape[1] or pic.opened[1][1] > px.shape[0]:
            # the resize box is the open size (a TIFF's XMP orientation
            # transposed the load)
            raise ValueError("box can't exceed original image size")
    mapped = pic.mode in ("L", "LA") and pic.palette is not None
    if (px.shape[1], px.shape[0]) == (w, h):
        out = pic._with(px.copy())
        if mapped:  # Pillow's copy takes the core image's mode
            out.mode = "P" if pic.mode == "L" else "PA"
        return out
    if mapped:  # a TGA's L or LA with a colour map: its core image is P or PA
        raise ValueError("image has wrong mode" if pic.mode == "L" else
                         "conversion from L to La not supported")
    if pic.mode in ("1", "P"):
        rows = _nearest_index(px.shape[0], h)
        cols = _nearest_index(px.shape[1], w)
        return pic._with(px[rows][:, cols])
    if pic.mode in ("I;16", "I;16L", "I;16B"):
        return pic._with(resize_lanczos_16(px, (w, h), pic.mode == "I;16B"))
    if pic.mode in ("I", "F"):
        return pic._with(resize_lanczos_32(px, pic.mode, (w, h)))
    if pic.mode == "LAB":  # Pillow resamples the core image's bytes, and
        # the fourth byte of its pixels comes out 0
        out = pic._with(resize_lanczos(px ^ _LAB_CORE, "LAB", (w, h))
                        ^ _LAB_CORE)
        out.pad = 0
        return out
    out = pic._with(resize_lanczos(px, pic.mode, (w, h)))
    if pic.mode == "PA":  # the resampled core image has an empty palette
        out.palette = np.zeros((0, 3), np.uint8)
    return out


def gaussian_blur(pic: Picture, radius: float) -> Picture:
    """``Image.filter(ImageFilter.GaussianBlur(radius))``."""
    if pic.mode not in ("L", "LA", "RGB", "RGBA", "CMYK") or (
            pic.palette is not None and pic.mode in ("L", "LA")):
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
    if mode == "P" or (mode == "L" and pic.palette is not None):
        return _palette(pic)[px]
    if mode == "PA" or (mode == "LA" and pic.palette is not None):
        return _palette(pic)[px[..., 0]]
    if mode == "LAB":
        return lcms.lab_to_rgb(px ^ _LAB_CORE)
    if mode == "CMYK":
        return _cmyk_to_rgb(px)
    if mode == "YCbCr":
        return jpeg2000.ycc_to_rgb(px)
    return np.repeat(_gray(pic)[..., None], 3, -1)


def _gray(pic: Picture) -> np.ndarray:
    px, mode = pic.pixels, pic.mode
    if mode in ("L", "1"):
        return px
    if mode == "YCbCr":  # ycbcr2l: the Y band
        return px[..., 0]
    if mode in ("I;16", "I;16L", "I;16B", "I"):
        return np.clip(px, 0, 255).astype(np.uint8)
    if mode == "F":  # f2l: clipped, then truncated (NaN as C's cast: 0)
        with np.errstate(invalid="ignore"):
            return np.where(px >= 255.0, 255, np.where(
                px > 0.0, np.nan_to_num(px), 0)).astype(np.uint8)
    if mode == "LA" and pic.palette is None:
        return px[..., 0]
    if mode == "LAB":  # Pillow goes to L by way of RGB, which LAB refuses
        raise ValueError(f"{pic.name}: conversion from LAB to RGB not "
                         "supported")
    return _luma(_rgb(pic))


def convert(pic: Picture, mode: str) -> np.ndarray:
    """``np.asarray(Image.convert(mode))`` for ``mode`` ``L``, ``RGB`` or
    ``RGBA``."""
    if pic.core is not None:  # Pillow converts the core image
        pic = pic._with(pic.core)
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
    if src in ("LA", "PA"):
        alpha = pic.pixels[..., 1]
    elif src == "P" or (src == "L" and pic.palette is not None):
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
    elif src == "LAB":  # the core image's fourth byte, copied by Pillow
        alpha = np.full(rgb.shape[:2], pic.pad, np.uint8)
    else:  # CMYK, I;16B, I, F
        alpha = np.full(rgb.shape[:2], 255, np.uint8)
    return np.concatenate([rgb, alpha[..., None]], -1)
