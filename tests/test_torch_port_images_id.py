"""The rest of ``Image.ID`` against Pillow 12.1 and through the JAX loader
functions, bit for bit: BLP, DCX, FITS, FLI, FTEX, GBR, ICNS, IM, IMT,
IPTC, MCIDAS, MSP, PCD, PIXAR, SPIDER, SUN, XBM, XPM and XVTHUMB; the
``YCbCr`` mode; the rawmodes of ``data/unpack.py``; and the C++ stages
(SUN runs, MSP rows, FLI frames, ICNS channels) against their plain
Python versions.

IM: every image type whose rawmode Pillow reads raw (``RGB;L``, ``RGB;T``,
``LA;L``, ``RGBA;L``, ``RGBX;L``, ``CMYK;L``, ``YCbCr;L``, ``P;2``,
``P;4``, ``I;32``, ``I;32S``, ``F;8`` to ``F;32F``, ``I;16``/``L``/``B``),
gray and colour ``Lut``s.  SUN: depths 1, 4, 8, 24 and 32, raw and
run-length, colour maps.  FITS: ``BITPIX`` 8, 16, 32, -32 and -64,
``NAXIS`` 1, gzip tables.  BLP: palettes with and without alpha, DXT1/3/5
at alpha depths 0, 1, 4 and 8 and a width that is not a multiple of 4,
BLP1 JPEG (gray, YCbCr, CMYK).  ICNS: PNG, JPEG 2000 and run-length
payloads with masks, Pillow's pick of the icon.  PCD: both turns.  FLI:
COLOR 4 and 11, BLACK, BRUN, COPY, LC and SS2.  The files come from
Pillow's ``save`` where it writes the layout, else from
``tests/image_writers.py``.  Each refusal Pillow makes raises
``ValueError`` naming the file.
"""
import io
import struct

import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu_torch.data import (fli, icns, image as port_image, msp, pcd,
                                    rle, sun, unpack)

import image_writers as W
from test_torch_port_images import WH, hold_loaders

H, WW = WH[1], WH[0]


def _img(rng, shape, top=256):
    """Runs, gradients and noise."""
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = ((xx // 3 * 5 + yy * 3) * (top // 64 + 1)) % top
    if len(shape) == 3:
        smooth = np.repeat(smooth[..., None], shape[2], -1)
    out = np.where(rng.rand(*shape) < 0.5, smooth, rng.randint(0, top, shape))
    out[: h // 4] = out[0, 0]  # long runs
    return out.astype(np.int64)


def _pil_save(img, fmt, mode=None, **kw):
    b = io.BytesIO()
    im = img if isinstance(img, Image.Image) else Image.fromarray(img)
    (im.convert(mode) if mode else im).save(b, fmt, **kw)
    return b.getvalue()


def _planes(px, k):
    """(h, w, k) -> rows bottom to top of k planes each (IM's ``;L``)."""
    return px[::-1].transpose(0, 2, 1).astype(np.uint8).tobytes()


# ------------------------------------------------------------------- IM
def _im_cases(rng):
    rgb = _img(rng, (H, WW, 3)).astype(np.uint8)
    rgba = _img(rng, (H, WW, 4)).astype(np.uint8)
    gray = _img(rng, (H, WW)).astype(np.uint8)
    pal = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    words = rng.randint(0, 65536, (H, WW))
    out = [("im-pillow-rgb", _pil_save(rgb, "IM")),
           ("im-pillow-rgba", _pil_save(rgba, "IM")),
           ("im-pillow-l", _pil_save(gray, "IM")),
           ("im-pillow-1", _pil_save(gray, "IM", "1")),
           ("im-pillow-la", _pil_save(rgba[..., :2].copy(), "IM")),
           ("im-pillow-p", _pil_save(rgb, "IM", "P")),
           ("im-pillow-pa", _pil_save(Image.fromarray(rgb).convert("P").convert(
               "PA"), "IM")),
           ("im-pillow-cmyk", _pil_save(rgb, "IM", "CMYK")),
           ("im-pillow-ycbcr", _pil_save(rgb, "IM", "YCbCr")),
           ("im-pillow-i", _pil_save(Image.fromarray(
               (words * 7 - 200000).astype(np.int32)), "IM")),
           ("im-pillow-f", _pil_save(Image.fromarray(
               (words / 97.0 - 300).astype(np.float32)), "IM")),
           ("im-pillow-i16", _pil_save(Image.fromarray(
               words.astype(np.uint16)), "IM"))]
    body = b"".join(rgb[::-1, :, k].tobytes() for k in (1, 0, 2))
    out += [("im-rgb3", W.im_bytes(body, "RGB3 image", (WW, H))),
            ("im-x24", W.im_bytes(rgb[::-1].tobytes(), "X 24 image",
                                  (WW, H))),
            ("im-rgbx", W.im_bytes(_planes(np.concatenate(
                [rgb, gray[..., None]], -1), 4), "RGBX image", (WW, H)))]
    for t, dt in (("L 32 S", "<u4"), ("L 32S", "<i4"), ("L 8", "u1"),
                  ("L 8S", "i1"), ("L 16S", "<i2"), ("L 32", "<u4"),
                  ("L 16", "<u2"), ("L 16L", "<u2"), ("L 16B", ">u2")):
        v = rng.randint(0, 1 << 31, (H, WW)).astype(np.int64)
        vals = v.astype(np.dtype(dt).newbyteorder("=")).astype(dt)
        out.append((f"im-{t.replace(' ', '')}",
                    W.im_bytes(vals[::-1].tobytes(), f"{t} image", (WW, H))))
    for bits in (3, 12, 31):  # Pillow's bit decoder
        out.append((f"im-Lstar{bits}", W.im_bytes(rng.randint(
            0, 256, (bits * WW + 7) // 8 * H).astype(np.uint8).tobytes(),
            f"L*{bits} image", (WW, H))))
    f = (rng.normal(0, 300, (H, WW))).astype("<f4")
    out.append(("im-L32F", W.im_bytes(f[::-1].tobytes(), "L 32F image",
                                      (WW, H))))
    for bits in (2, 4):
        idx = _img(rng, (H, WW), 1 << bits).astype(np.uint8)
        per = 8 // bits
        packed = np.zeros((H, -(-WW // per)), np.uint8)
        for k in range(per):
            col = idx[:, k::per]
            packed[:, :col.shape[1]] |= col << (8 - bits * (k + 1))
        out.append((f"im-b{bits}", W.im_bytes(packed[::-1].tobytes(),
                                               f"B{bits} image", (WW, H))))
    lut_gray = bytes(np.repeat((255 - np.arange(256)).astype(np.uint8)[None],
                               3, 0).reshape(-1))
    lut = pal.T.tobytes()
    out += [("im-gray-lut", W.im_bytes(gray[::-1].tobytes(),
                                       "Greyscale image", (WW, H), lut_gray)),
            ("im-colour-lut", W.im_bytes(gray[::-1].tobytes(),
                                         "Greyscale image", (WW, H), lut)),
            ("im-la-colour-lut", W.im_bytes(
                _planes(rgba[..., :2], 2), "LA image", (WW, H), lut)),
            ("im-rgb-lut-ignored", W.im_bytes(_planes(rgb, 3), "RGB image",
                                              (WW, H), lut)),
            ("im-comments", W.im_bytes(_planes(rgb, 3), "RGB image", (WW, H),
                                       extra=("Comment: one",
                                              "Comment: two")))]
    return out


# ------------------------------------------------------------------ SUN
def _sun_cases(rng):
    out = []
    gray = _img(rng, (H, WW)).astype(np.uint8)
    rgb = _img(rng, (H, WW, 3)).astype(np.uint8)
    rgb[5, :] = 0x80  # literal 0x80 bytes in the runs
    bits = np.packbits(_img(rng, (H, WW), 2).astype(np.uint8), axis=1)
    nib = _img(rng, (H, WW), 16).astype(np.uint8)
    nibs = (nib[:, 0::2] << 4) | np.pad(nib[:, 1::2], ((0, 0), (0, 0)))
    pal = rng.randint(0, 256, (200, 3))
    pal16 = rng.randint(0, 256, (16, 3))
    for ftype in (1, 2):
        tag = "rle" if ftype == 2 else "raw"
        out += [(f"sun-1-{tag}", W.sun_bytes(bits, WW, 1, ftype)),
                (f"sun-4-{tag}", W.sun_bytes(nibs, WW, 4, ftype)),
                (f"sun-8-{tag}", W.sun_bytes(gray, WW, 8, ftype)),
                (f"sun-8-map-{tag}", W.sun_bytes(gray % 200, WW, 8, ftype,
                                                 palette=pal)),
                (f"sun-4-map-{tag}", W.sun_bytes(nibs, WW, 4, ftype,
                                                 palette=pal16)),
                (f"sun-24-{tag}", W.sun_bytes(rgb[..., ::-1].reshape(H, -1),
                                              WW, 24, ftype)),
                (f"sun-32-{tag}", W.sun_bytes(np.concatenate(
                    [rgb[..., ::-1], gray[..., None]], -1).reshape(H, -1),
                    WW, 32, ftype))]
    out += [("sun-24-type3", W.sun_bytes(rgb.reshape(H, -1), WW, 24, 3)),
            ("sun-32-type3", W.sun_bytes(np.concatenate(
                [rgb, gray[..., None]], -1).reshape(H, -1), WW, 32, 3)),
            ("sun-8-odd", W.sun_bytes(gray[:, :37], 37, 8)),
            ("sun-8-rle-odd", W.sun_bytes(gray[:, :37], 37, 8, 2))]
    return out


# ------------------------------------------------------------ raw ones
def _raw_cases(rng):
    gray = _img(rng, (H, WW)).astype(np.uint8)
    rgb = _img(rng, (H, WW, 3)).astype(np.uint8)
    rgba = _img(rng, (H, WW, 4)).astype(np.uint8)
    words = rng.randint(-40000, 40000, (H, WW))
    out = []
    for bitpix, img in ((8, gray), (16, words), (32, words * 3001),
                        (-32, words / 7.0), (-64, words / 3.0)):
        out.append((f"fits-{bitpix}", W.fits_bytes(img, bitpix)))
    out += [("fits-naxis1", W.fits_bytes(gray[:1], 8, naxis1_only=True)),
            ("fits-gzip-8", W.fits_bytes(gray, 8, gzip_words=True)),
            ("fits-gzip-16", W.fits_bytes(words, 16, gzip_words=True)),
            ("fits-gzip-32", W.fits_bytes(words * 3001, 32, gzip_words=True))]
    out += [("mcidas-1", W.mcidas_bytes(gray, 1, prefix=4)),
            ("mcidas-2", W.mcidas_bytes(words + 40000, 2)),
            ("mcidas-4", W.mcidas_bytes(words * 9 + 2 ** 31, 4, prefix=2)),
            ("pixar-rgb", W.pixar_bytes(rgb)),
            ("spider-pillow", _pil_save(Image.fromarray(
                (words / 11.0).astype(np.float32)), "SPIDER")),
            ("spider-big", W.spider_bytes(words / 5.0)),
            ("spider-little", W.spider_bytes(words / 5.0, big=False)),
            ("spider-stack", W.spider_bytes(words / 3.0, stack=True)),
            ("gbr-v1", W.gbr_bytes(gray, 1)),
            ("gbr-v2-l", W.gbr_bytes(gray, 2)),
            ("gbr-v2-rgba", W.gbr_bytes(rgba, 2, comment=b"a colour brush")),
            ("xvthumb", W.xvthumb_bytes(gray)),
            ("imt", W.imt_bytes(gray))]
    return out


# ------------------------------------------------- XBM, XPM, MSP, DCX
def _bitmap_cases(rng):
    bits = _img(rng, (H, WW), 2).astype(np.uint8) * 255
    packed_lsb = np.packbits(bits > 0, axis=1, bitorder="little")
    packed = np.packbits(bits > 0, axis=1)
    packed[3] = 0xFF  # an empty v2 row
    idx = _img(rng, (H, WW), 40)
    cols = [tuple(c) for c in rng.randint(0, 256, (40, 3))]
    big = _img(rng, (H, WW), 300)
    pcx_rgb = W.pcx_bytes(_img(rng, (3, H, WW)), 8)
    pcx_p = W.pcx_bytes(_img(rng, (1, H, WW)), 8,
                        palette256=rng.randint(0, 256, (256, 3)))
    return [("xbm-pillow", _pil_save(bits, "XBM", "1")),
            ("xbm-hotspot", W.xbm_bytes(packed_lsb, WW, hotspot=(3, 4))),
            ("xpm-p", W.xpm_bytes(idx, cols)),
            ("xpm-none-unused", W.xpm_bytes(idx, cols + [None])),
            ("xpm-cpp2", W.xpm_bytes(idx, cols, cpp=2)),
            ("xpm-rgb", W.xpm_bytes(big, [tuple(c) for c in rng.randint(
                0, 256, (300, 3))], cpp=2)),
            ("msp-pillow", _pil_save(bits, "MSP", "1")),
            ("msp-v2", W.msp_bytes(packed)),
            ("dcx-rgb", W.dcx_bytes([pcx_rgb, pcx_p])),
            ("dcx-p", W.dcx_bytes([pcx_p]))]


# ------------------------------------------------------------------ FLI
def _fli_cases(rng):
    idx = _img(rng, (H, WW)).astype(np.uint8)
    pal = rng.randint(0, 256, (256, 3))
    pal64 = rng.randint(0, 64, (256, 3))
    lc = W.fli_lc(2, [[(1, b"\x05" * 7), (3, bytes(range(9)))], [],
                      [(0, bytes(rng.randint(0, 256, 40).astype(np.uint8)))]])
    ss2 = W.fli_ss2([(0, [(2, b"\x01\x02" * 3), (1, bytes(range(10)))], None),
                     (3, [(0, b"\x09\x08" * 19)], None),
                     (0, [(4, b"\x07\x07\x07\x07")], 0x55)])
    return [("fli-brun", W.fli_bytes(WW, H, [W.fli_color(pal),
                                             W.fli_chunk(15, W.fli_brun(idx))])),
            ("fli-11-brun", W.fli_bytes(WW, H, [
                W.fli_color(pal64, 11), W.fli_chunk(15, W.fli_brun(idx))],
                magic=0xAF11)),
            ("fli-color-skip", W.fli_bytes(WW, H, [
                W.fli_color(pal[:100], skip=20),
                W.fli_chunk(15, W.fli_brun(idx))])),
            ("fli-copy", W.fli_bytes(WW, H, [W.fli_chunk(16, idx.tobytes())])),
            ("fli-black", W.fli_bytes(WW, H, [W.fli_chunk(16, idx.tobytes()),
                                              W.fli_chunk(13, bytes(4))])),
            ("fli-lc", W.fli_bytes(WW, H, [W.fli_color(pal),
                                           W.fli_chunk(16, idx.tobytes()),
                                           W.fli_chunk(12, lc)])),
            ("fli-ss2", W.fli_bytes(WW - 1, H, [
                W.fli_chunk(16, idx[:, :WW - 1].tobytes()),
                W.fli_chunk(7, ss2)]))]


# ------------------------------------------------------- FTEX, BLP
def _dxt(rng, n, count):
    size = 8 if n == 1 else 16
    b = rng.randint(0, 256, (count, size)).astype(np.uint8)
    col = b[:, -8:]
    swap = rng.rand(count) < 0.5  # both DXT1 colour rules
    c0 = col[:, 0:2].copy()
    col[swap, 0:2], col[swap, 2:4] = col[swap, 2:4], c0[swap]
    if n == 5:
        b[::3, 0], b[::3, 1] = b[::3, 1], b[::3, 0]
    return b.tobytes()


def _blp_cases(rng):
    out = []
    nb = -(-WW // 4) * -(-H // 4)
    pal = rng.randint(0, 256, (256, 4)).astype(np.uint8)
    idx = _img(rng, (H, WW)).astype(np.uint8)
    for depth in (0, 1, 4, 8):
        out.append((f"blp-dxt1-a{depth}", W.blp2_bytes(
            WW, H, 2, depth, 0, _dxt(rng, 1, nb))))
        out.append((f"blp-palette-a{depth}", W.blp2_bytes(
            WW, H, 1, depth, 0, idx.tobytes(), pal)))
    for depth in (0, 8):
        out += [(f"blp-dxt3-a{depth}", W.blp2_bytes(WW, H, 2, depth, 1,
                                                    _dxt(rng, 3, nb))),
                (f"blp-dxt5-a{depth}", W.blp2_bytes(WW, H, 2, depth, 7,
                                                    _dxt(rng, 5, nb)))]
    nb38 = -(-38 // 4) * -(-H // 4)
    out.append(("blp-dxt5-w38", W.blp2_bytes(38, H, 2, 8, 7,
                                             _dxt(rng, 5, nb38))))
    rgb = _img(rng, (H, WW, 3)).astype(np.uint8)
    p = Image.fromarray(rgb).convert("P")
    out += [("blp-pillow-blp2", _pil_save(p, "BLP")),
            ("blp-pillow-blp1", _pil_save(p, "BLP", blp_version="BLP1"))]
    for tag, im in (("ycbcr", Image.fromarray(rgb)),
                    ("gray", Image.fromarray(rgb).convert("L")),
                    ("cmyk", Image.fromarray(rgb).convert("CMYK"))):
        j = _pil_save(im, "JPEG", quality=90)
        out.append((f"blp-jpeg-{tag}", W.blp1_jpeg_bytes(WW, H, j, 200)))
    out.append(("ftex-dxt1", W.ftex_bytes(WW, H, 0, _dxt(rng, 1, nb))))
    out.append(("ftex-rgb", W.ftex_bytes(WW, H, 1, rgb.tobytes())))
    return out


# --------------------------------------------------------- ICNS, IPTC
def _icns_cases(rng):
    def rgb_of(n):
        return _img(rng, (n, n, 3)).astype(np.uint8)

    def mask_of(n):
        return _img(rng, (n, n)).astype(np.uint8).tobytes()

    png32 = _pil_save(_img(rng, (32, 32, 4)).astype(np.uint8), "PNG")
    j2k = _pil_save(rgb_of(16), "JPEG2000")
    p16 = _pil_save(rgb_of(32), "PNG", "P")
    return [("icns-it32-t8mk", W.icns_bytes([
                (b"it32", W.icns_channels(rgb_of(128), sig=True)),
                (b"t8mk", mask_of(128))])),
            ("icns-is32-s8mk", W.icns_bytes([
                (b"is32", W.icns_channels(rgb_of(16))),
                (b"s8mk", mask_of(16))])),
            ("icns-il32-no-mask", W.icns_bytes([
                (b"il32", W.icns_channels(rgb_of(32)))])),
            ("icns-ih32-raw", W.icns_bytes([
                (b"ih32", rgb_of(48).transpose(2, 0, 1).tobytes()),
                (b"h8mk", mask_of(48))])),
            ("icns-pick", W.icns_bytes([
                (b"is32", W.icns_channels(rgb_of(16))),
                (b"ic11", png32),
                (b"il32", W.icns_channels(rgb_of(32)))])),
            ("icns-png-p", W.icns_bytes([(b"ic12", p16)])),
            ("icns-png-over-channels", W.icns_bytes([
                (b"icp5", _pil_save(rgb_of(32), "PNG", "L")),
                (b"il32", W.icns_channels(rgb_of(32))),
                (b"l8mk", mask_of(32))])),
            ("icns-jpeg2000", W.icns_bytes([(b"icp4", j2k)]))]


def _iptc_cases(rng):
    gray = _img(rng, (H, WW)).astype(np.uint8)
    raw = gray.tobytes()
    return [("iptc-l", W.iptc_bytes(raw, WH, 1, 0)),
            ("iptc-rgb-band2", W.iptc_bytes(raw, WH, 3, 1, band=2)),
            ("iptc-rgb-no-band", W.iptc_bytes(raw, WH, 3, 1)),
            ("iptc-cmyk-band4", W.iptc_bytes(raw, WH, 4, 1, band=4,
                                             chunk=333)),
            ("iptc-jpeg", W.iptc_bytes(_pil_save(gray, "JPEG"), WH, 1, 0,
                                       compression=5)),
            ("iptc-jpeg-band1", W.iptc_bytes(_pil_save(gray, "JPEG"), WH, 3,
                                             1, band=1, compression=5))]


def _cases():
    rng = np.random.RandomState(20)
    return (_im_cases(rng) + _sun_cases(rng) + _raw_cases(rng)
            + _bitmap_cases(rng) + _fli_cases(rng) + _blp_cases(rng)
            + _icns_cases(rng) + _iptc_cases(rng))


CASES = _cases()


def _pil_pixels(pil):
    want = np.asarray(pil)
    if pil.mode == "1":
        want = want.astype(np.uint8) * 255
    if want.dtype.byteorder == ">":
        want = want.astype(want.dtype.newbyteorder("="))
    return want


def _hold_picture(path, pil):
    """The port's picture against Pillow's image: mode, pixels, palette,
    transparency."""
    want = _pil_pixels(pil)
    pic = port_image.read_picture(path)
    assert pic.mode == pil.mode
    assert pic.pixels.dtype == want.dtype and pic.pixels.shape == want.shape
    np.testing.assert_array_equal(pic.pixels, want)
    if pic.mode in ("P", "PA"):
        pal = np.array(pil.getpalette() or [], np.uint8).reshape(-1, 3)
        n = min(len(pal), len(pic.palette))
        np.testing.assert_array_equal(pic.palette[:n], pal[:n])
    assert pic.transparency == pil.info.get("transparency")
    for mode in ("L", "RGB", "RGBA"):
        try:
            conv = np.asarray(pil.convert(mode))
        except ValueError:
            with pytest.raises(ValueError):
                port_image.convert(pic, mode)
            continue
        np.testing.assert_array_equal(port_image.convert(pic, mode), conv,
                                      err_msg=mode)
    return pic


@pytest.mark.parametrize("name,data", CASES, ids=[c[0] for c in CASES])
def test_layout_matches_pillow_and_jax_loaders(tmp_path, name, data):
    path = str(tmp_path / f"{name}.img")
    with open(path, "wb") as f:
        f.write(data)
    pil = Image.open(path)
    pil.load()
    assert pil.format.upper() == name.split("-")[0].upper(), pil.format
    _hold_picture(path, pil)
    opened = Image.open(path).size  # an ICNS payload may have its own
    if opened[0] % 2 == 0 and opened[1] % 2 == 0:
        hold_loaders(path, opened)


@pytest.mark.parametrize("orientation", [0, 1, 3])
def test_pcd_matches_pillow_and_jax_loaders(tmp_path, orientation):
    """The 768x512 base image, PhotoYCC to RGB, turned 90 or 270 degrees
    by the orientation byte; the loaders on the turned one."""
    rng = np.random.RandomState(orientation)
    y = _img(rng, (512, 768))
    cb, cr = (_img(rng, (256, 384)) for _ in range(2))
    path = tmp_path / "photo.pcd"
    path.write_bytes(W.pcd_bytes(y, cb, cr, orientation | 4))
    pil = Image.open(path)
    pil.load()
    assert pil.format == "PCD"
    _hold_picture(str(path), pil)
    if orientation == 1:
        hold_loaders(str(path), pil.size)


def test_photo_ycc_tables_match_pillow():
    """Every (y, cb) and (y, cr) pair, and every (cb, cr) pair at four luma
    values, through Pillow's ``pcd`` decoder and the port's tables."""
    p = np.arange(256)[:, None]
    ys = [np.tile(np.arange(768) % 256, (512, 1))]
    chroma = [(np.repeat(p, 384, 1), np.repeat(p, 384, 1))]
    for ya, yb in ((0, 255), (60, 140)):
        y = np.zeros((512, 768), np.int64)
        y[0::2], y[1::2] = ya, yb
        ys.append(y)
        chroma.append((np.tile(np.arange(384) % 256, (256, 1)),
                       np.repeat(p, 384, 1)))
    for y, (cb, cr) in zip(ys, chroma):
        pil = Image.open(io.BytesIO(W.pcd_bytes(y, cb, cr)))
        x = np.arange(768)
        got = pcd.photo_ycc_to_rgb(y, np.repeat(cb[:, x // 2], 2, 0),
                                   np.repeat(cr[:, x // 2], 2, 0))
        np.testing.assert_array_equal(got, np.asarray(pil))


def test_ycbcr_mode_as_pillow(tmp_path):
    """An IM ``YCC image`` of every (cb, cr): ``convert`` to L (the Y band),
    RGB and RGBA in Pillow's fixed point, ``resize`` in 8 bits and the
    blur's refusal, as Pillow does them."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256))
    for y in (0, 77, 200, 255):
        ycc = np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)
        path = tmp_path / f"ycc{y}.im"
        path.write_bytes(_pil_save(Image.fromarray(ycc, "YCbCr"), "IM"))
        pil = Image.open(path)
        pic = _hold_picture(str(path), pil)
        assert pic.mode == "YCbCr"
    small = port_image.resize(pic, (100, 60))
    np.testing.assert_array_equal(small.pixels, np.asarray(
        pil.resize((100, 60), Image.LANCZOS)))
    with pytest.raises(ValueError, match="image has wrong mode"):
        Image.open(path).filter(__import__("PIL.ImageFilter").ImageFilter
                                .GaussianBlur(2))
    with pytest.raises(ValueError, match="wrong mode"):
        port_image.gaussian_blur(pic, 2)


RAWMODES = [("1", "1"), ("1", "1;I"), ("1", "1;R"), ("L", "L;4"),
            ("P", "P;4"), ("P", "P;2"), ("RGB", "RGB;L"), ("I", "I;32"),
            ("I", "I;32S"), ("I", "I;32B"), ("F", "F;32"), ("F", "F;32S"),
            ("F", "F;8"), ("F", "F;8S"), ("F", "F;16"), ("F", "F;16S"),
            ("F", "F;32F"), ("F", "F;32BF"), ("F", "F;64F"), ("F", "F;64BF"),
            ("LA", "LA;L"), ("PA", "PA;L"), ("RGBA", "RGBA;L"),
            ("RGB", "RGBX;L"), ("CMYK", "CMYK;L"), ("YCbCr", "YCbCr;L"),
            ("I;16", "I;16"), ("I;16L", "I;16L"), ("I;16B", "I;16B"),
            ("RGB", "BGR"), ("RGB", "BGRX"), ("RGB", "RGBX"),
            ("RGBA", "BGR"), ("L", "L"), ("P", "P"), ("I", "I"),
            ("F", "F"), ("RGBA", "RGBA"), ("CMYK", "CMYK"), ("LA", "LA")]


@pytest.mark.parametrize("mode,rawmode", RAWMODES,
                         ids=[f"{m}-{r}" for m, r in RAWMODES])
def test_rawmodes_as_pillows_unpackers(mode, rawmode):
    """``unpack.raw`` against ``Image.frombytes`` at widths that end a byte
    and that do not, with a row stride and bottom to top."""
    rng = np.random.RandomState(len(rawmode))
    for w in (5, 8, 13):
        if rawmode.startswith("F;") and rawmode.endswith("F"):
            n = 8 if "64" in rawmode else 4
            data = rng.normal(0, 1000, 200).astype(
                (">" if "B" in rawmode else "<") + f"f{n}").tobytes()
        else:
            data = rng.randint(0, 256, 1600).astype(np.uint8).tobytes()
        rb = unpack.row_bytes(w, rawmode)
        for stride, ystep in ((0, 1), (rb + 3, 1), (0, -1)):
            pil = Image.frombytes(mode, (w, 4), data, "raw", rawmode, stride,
                                  ystep)
            got = unpack.raw(data, 0, (w, 4), mode, rawmode, stride, ystep)
            np.testing.assert_array_equal(got, _pil_pixels(pil))
    if rawmode == "L":
        for bad_mode, bad in (("RGB", "RLB"), ("LA", "PA;L")):
            with pytest.raises(ValueError, match="unknown raw mode"):
                Image.frombytes(bad_mode, (4, 4), data, "raw", bad)
            with pytest.raises(ValueError, match="unknown raw mode"):
                unpack.raw(data, 0, (4, 4), bad_mode, bad)


def test_stages_equal_their_plain_versions():
    """Each C++ stage (SUN runs, MSP v2 rows, FLI frames, ICNS channels)
    against its plain Python version on the writers' streams, cut short,
    and on random bytes, where both must give the same bytes or the same
    error."""
    rng = np.random.RandomState(11)

    def same(plain, native, *args):
        try:
            want = plain(*args)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                native(*args)
            return 0
        got = native(*args)
        if isinstance(want, tuple):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)
        return 1

    decoded = 0
    for _ in range(30):
        w, h = (int(v) for v in rng.randint(1, 40, 2))
        img = _img(rng, (h, w)).astype(np.uint8)
        junk = rng.randint(0, 256, rng.randint(0, 400)).astype(
            np.uint8).tobytes()
        body = W.sun_rle(img.tobytes())
        for data in (body, junk, body[:len(body) // 2], b"\x80\x05" + body):
            decoded += same(sun.rle_plain, rle.sun_rle, data, w, h)
        bits = np.packbits(_img(rng, (h, 8 * -(-w // 8)), 2).astype(
            np.uint8), axis=1)
        data = W.msp_bytes(bits)
        cap = h * -(-w // 8)
        for d in (data, data[:len(data) - 3], data[:32] + junk):
            decoded += same(msp.rows_plain, rle.msp_rows, d, w, h, cap)
        frames = [W.fli_chunk(15, W.fli_brun(img)),
                  W.fli_chunk(16, img.tobytes()),
                  W.fli_chunk(12, W.fli_lc(int(rng.randint(0, h)), [
                      [(int(rng.randint(0, 5)), bytes(rng.randint(
                          0, 256, int(rng.randint(1, 6))).astype(np.uint8)))]
                      for _ in range(int(rng.randint(1, 4)))]))]
        for chunk in frames:
            buf = W.fli_bytes(w, h, [chunk])[128:]
            for d in (buf, buf[:len(buf) // 2], buf[:16] + junk):
                decoded += same(fli.frame_plain, rle.fli_frame, d, w, h)
        rgb = _img(rng, (h, w, 3)).astype(np.uint8)
        body = W.icns_channels(rgb)
        for d in (body, body[:len(body) - 5], junk):
            decoded += same(icns.rgb_plain, rle.icns_rgb, d, w * h)
    assert decoded > 150


def _refusals(rng):
    gray = _img(rng, (H, WW)).astype(np.uint8)
    rgb = _img(rng, (H, WW, 3)).astype(np.uint8)
    nb = -(-WW // 4) * -(-H // 4)
    bits = np.packbits(gray > 99, axis=1)
    msp2 = W.msp_bytes(bits)
    bad_run = bytearray(msp2)
    rows_at = 32 + 2 * H
    first = struct.unpack_from("<H", msp2, 32)[0]
    bad_run[rows_at + first - 3:rows_at + first] = b"\x05\x00\x03"
    fits_hdr = W.fits_bytes(gray, 8)
    no_image = W.fits_bytes(gray, 8)[:2880].replace(
        b"NAXIS   =                    2", b"NAXIS   =                    0")
    im_head = W.im_bytes(b"", "RGB image", (WW, H))
    blp_dxt = W.blp2_bytes(WW, H, 2, 8, 7, _dxt(rng, 5, nb))
    ftex2 = bytearray(W.ftex_bytes(WW, H, 0, _dxt(rng, 1, nb)))
    ftex2[20:24] = struct.pack("<i", 2)
    icns_png = W.icns_bytes([(b"ic07", _pil_save(rgb, "PNG"))])
    spider_img = bytearray(W.spider_bytes(gray / 3.0))
    spider_img[4 * 26:4 * 27] = struct.pack(">f", 2.0)
    return {
        "im-rlb.im": W.im_bytes(_planes(rgb, 3), "RLB image", (WW, H)),
        "im-pa.im": W.im_bytes(_planes(rgb[..., :2], 2), "PA image", (WW, H)),
        "im-unknown-type.im": W.im_bytes(gray[::-1].tobytes(), "Q 9 image",
                                         (WW, H)),
        "im-cut.im": im_head + _planes(rgb, 3)[:-50],
        "im-bits-cut.im": W.im_bytes(bytes(100), "L*12 image", (WW, H)),
        "im-no-data.im": im_head[:-1],
        "sun-1-map.ras": W.sun_bytes(bits, WW, 1, palette=np.zeros((2, 3))),
        "sun-16.ras": W.sun_bytes(gray, WW // 2, 16),
        "sun-type-9.ras": W.sun_bytes(gray, WW, 8, 9),
        "sun-cut.ras": W.sun_bytes(gray, WW, 8)[:-100],
        "sun-rle-cut.ras": W.sun_bytes(gray, WW, 8, 2)[:-10],
        "fits-no-image.fits": no_image,
        "fits-cut.fits": fits_hdr[:2800],
        "fits-body-cut.fits": fits_hdr[:2880 + 500],
        "fits-gzip-float.fits": W.fits_bytes(gray / 3.0, -32, gzip_words=True),
        "fits-bad-gzip.fits": W.fits_bytes(gray, 8, gzip_words=True)[:-40],
        "mcidas-3.area": W.mcidas_bytes(gray, 1)[:40] + struct.pack(">i", 3)
        + W.mcidas_bytes(gray, 1)[44:],
        "mcidas-cut.area": W.mcidas_bytes(gray, 1)[:-7],
        "spider-stack-image.spi": bytes(spider_img),
        "gbr-cut.gbr": W.gbr_bytes(gray)[:-9],
        "xvthumb-one-number.xv": b"P7 332\n#END\n40\n" + bytes(1200),
        "xbm-cut.xbm": W.xbm_bytes(np.packbits(gray > 9, axis=1,
                                               bitorder="little"), WW)[:-60],
        "xpm-named-colour.xpm": W.xpm_bytes(gray % 4, [(1, 2, 3)] * 4)
        .replace(b"#010203", b"red", 1),
        "xpm-none-used.xpm": W.xpm_bytes(gray % 4, [(1, 2, 3)] * 3 + [None]),
        "msp-v2-cut.msp": msp2[:-5],
        "msp-v2-bad-run.msp": bytes(bad_run),
        "msp-v1-cut.msp": _pil_save(gray, "MSP", "1")[:-20],
        "fli-black-last.fli": W.fli_bytes(WW, H, [W.fli_chunk(13, b"")]),
        "fli-ss2-too-wide.fli": W.fli_bytes(WW - 1, H, [W.fli_chunk(7, W.fli_ss2(
            [(0, [(0, b"\x09\x08" * 20)], None)]))]),
        "fli-unknown-chunk.fli": W.fli_bytes(WW, H, [W.fli_chunk(99,
                                                                 bytes(8))]),
        "fli-brun-cut.fli": W.fli_bytes(WW, H, [W.fli_chunk(
            15, W.fli_brun(gray))])[:-30],
        "fli-no-frames.fli": W.fli_bytes(WW, H, [W.fli_chunk(16, bytes(1200))],
                                         frames=0),
        "ftex-2-formats.ftc": bytes(ftex2),
        "ftex-format-3.ftc": W.ftex_bytes(WW, H, 3, bytes(100)),
        "ftex-cut.ftc": W.ftex_bytes(WW, H, 0, _dxt(rng, 1, nb))[:-20],
        "blp-encoding-3.blp": W.blp2_bytes(WW, H, 3, 8, 0, bytes(4 * WW * H)),
        "blp-alpha-encoding-5.blp": W.blp2_bytes(WW, H, 2, 8, 5, bytes(800)),
        "blp-cut.blp": blp_dxt[:-40],
        "blp-compression-2.blp": b"BLP2" + struct.pack("<i", 2)
        + blp_dxt[8:],
        "icns-png-size.icns": icns_png,
        "icns-runs-over.icns": W.icns_bytes([
            (b"is32", b"\x82\x05" * 300)]),
        "icns-mask-only.icns": W.icns_bytes([(b"s8mk", bytes(256))]),
        "icns-it32-sig.icns": W.icns_bytes([(b"it32", b"\1\0\0\0" + bytes(
            3 * 128 * 128))]),
        "icns-junk-payload.icns": W.icns_bytes([(b"ic07", bytes(500))]),
        "iptc-compression-3.iim": W.iptc_bytes(gray.tobytes(), WH, 1, 0,
                                               compression=3),
        "iptc-no-image.iim": W.iptc_bytes(b"", WH, 1, 0),
        "iptc-band-past.iim": W.iptc_bytes(gray.tobytes(), WH, 4, 1, band=6),
        "iptc-cut.iim": W.iptc_bytes(gray.tobytes(), WH, 1, 0)[:-200],
        "pcd-cut.pcd": W.pcd_bytes(np.zeros((512, 768)), np.zeros((256, 384)),
                                   np.zeros((256, 384)))[:-1000],
        "dcx-pcx-version-3.dcx": W.dcx_bytes([W.pcx_bytes(
            gray[None], 8, version=3)]),
        "imt-no-data.imt": W.imt_bytes(gray)[:-1201],
    }


def test_iptc_header_size_other_than_its_jpeg_as_pillow(tmp_path):
    """An IPTC file whose header's size is not its JPEG's: Pillow keeps the
    header's size over the JPEG's core image, so its array is the core's
    bytes from the start (the top rows where the widths agree), and its
    ``convert`` and a resize to the header's size give the core; a header
    that takes more bytes than the core holds raises in the port (Pillow's
    array reads past its image)."""
    rng = np.random.RandomState(28)
    gray = _img(rng, (H, WW)).astype(np.uint8)
    jpeg = _pil_save(gray, "JPEG")
    for size, band in (((WW, H - 10), None), ((30, 30), None),
                       ((20, 20), None), ((WW, H - 10), 1)):
        path = tmp_path / f"iptc-{size[0]}x{size[1]}-{band}"
        path.write_bytes(W.iptc_bytes(jpeg, size, 1 if band is None else 3,
                                      0 if band is None else 1, band=band,
                                      compression=5))
        pil = Image.open(path)
        pil.load()
        pic = port_image.read_picture(str(path))
        assert pic.mode == pil.mode
        np.testing.assert_array_equal(pic.pixels, np.asarray(pil))
        for mode in ("L", "RGB", "RGBA"):
            np.testing.assert_array_equal(port_image.convert(pic, mode),
                                          np.asarray(Image.open(path).convert(
                                              mode)))
        np.testing.assert_array_equal(
            port_image.resize(pic, size).pixels,
            np.asarray(Image.open(path).resize(size, Image.LANCZOS)))
    path = tmp_path / "iptc-taller"
    path.write_bytes(W.iptc_bytes(jpeg, (WW, H + 10), 1, 0, compression=5))
    with pytest.raises(ValueError, match="past the image data"):
        port_image.read_picture(str(path))


def test_refusals_name_the_file(tmp_path):
    """What Pillow refuses (its open or load raises, or no format takes the
    file) raises ``ValueError`` naming the file."""
    for name, body in _refusals(np.random.RandomState(5)).items():
        path = tmp_path / name
        path.write_bytes(body)
        with pytest.raises(Exception):
            Image.open(path).load()
        with pytest.raises(ValueError, match=rf"{name.replace('.', r'\.')}: "):
            port_image.read_picture(str(path))


def test_formats_fall_through_as_in_pillow(tmp_path):
    """An McIdas area starts with five zero bytes, which end IPTC's fields
    (its open fails: the next format); an IMT header that IM cannot read
    goes on to IMT; a SPIDER header whose ``iform`` is not 1 moves on."""
    rng = np.random.RandomState(2)
    gray = _img(rng, (H, WW)).astype(np.uint8)
    for name, data, fmt in (
            ("area", W.mcidas_bytes(gray, 1), "MCIDAS"),
            ("imt", W.imt_bytes(gray, b"* no colon here"), "IMT")):
        path = tmp_path / name
        path.write_bytes(data)
        assert Image.open(path).format == fmt
        assert port_image.open_format(data, name)[0] == fmt


def test_icns_pillow_save_matches_pillow(tmp_path):
    """Pillow's own ICNS (PNG payloads of every size to 1024x1024): the
    picture it picks (ic10's 1024x1024 PNG), held as Pillow gives it."""
    yy, xx = np.mgrid[0:64, 0:64]
    rgba = np.stack([xx * 4, yy * 4, xx + yy, 255 - yy], -1).astype(np.uint8)
    path = tmp_path / "pillow.icns"
    path.write_bytes(_pil_save(rgba, "ICNS"))
    pil = Image.open(path)
    pil.load()
    assert pil.format == "ICNS" and pil.size == (1024, 1024)
    _hold_picture(str(path), pil)


def _tiff_cases():
    """TIFF layouts of the last slices: orientations (tag 274 and XMP) over
    none, LZW, Deflate and tiles, uncompressed YCbCr, and zstd (one strip
    and strips of 7 rows, each frame's literals in four Huffman streams,
    which libzstd reads with its fast decoders).  (The fax layouts have
    their own corrupt-stream test in
    ``test_torch_port_images_tiff_codecs.py``: Pillow leaves the rows of a
    fax strip that ends early uninitialised.)"""
    import zstandard
    rng = np.random.RandomState(21)
    rgb = _img(rng, (H, WW, 3)).astype(np.uint8)
    gray = _img(rng, (H, WW)).astype(np.uint8)
    return [
        ("tiff-zstd", W.tiff_bytes(rgb, 2, 8, compression=50000,
                                   zstd_codec=zstandard.ZstdCompressor(
                                       level=3).compress)),
        ("tiff-zstd-strips", W.tiff_bytes(rgb, 2, 8, compression=50000,
                                          rows_per_strip=7, predictor=2)),
        ("tiff-o6-lzw", W.tiff_bytes(rgb, 2, 8, compression=5,
                                     tags=[(274, "H", [6])])),
        ("tiff-o3-tiles", W.tiff_bytes(rgb, 2, 8, tile=(16, 16),
                                       tags=[(274, "H", [3])])),
        ("tiff-o8-gray", W.tiff_bytes(gray, 1, 8, tags=[(274, "H", [8])])),
        ("tiff-xmp6", W.tiff_bytes(rgb, 2, 8, compression=8, tags=[
            (700, "B", list(b'<x tiff:Orientation="6"/>'))])),
        ("tiff-ycbcr-raw", W.tiff_bytes(rgb, 6, 8, rows_per_strip=7,
                                        tags=[(530, "H", [1, 1])])),
    ]


# the JPEG 2000 payload is left out: OpenJPEG's handling of corrupt
# codestreams is not modelled
MUTABLE = [c for c in CASES if "jpeg2000" not in c[0]] + _tiff_cases()


def test_mutated_files_agree_with_pillow(tmp_path):
    """Seeded mutations of the layouts above, their JPEG and PNG payloads
    included, and of the TIFF layouts of ``_tiff_cases`` (a byte changed in
    the header or anywhere, a bit flipped, the file cut): the port reads
    what Pillow reads, as Pillow reads it, and raises ``ValueError`` where
    Pillow raises."""
    rng = np.random.RandomState(20)
    path = tmp_path / "mutated.img"
    agreed = 0
    for _ in range(600):
        name, data = MUTABLE[rng.randint(len(MUTABLE))]
        d = bytearray(data)
        kind = rng.randint(4)
        if kind == 0:
            d = d[:rng.randint(len(d))]
        elif kind == 1:
            d[rng.randint(min(len(d), 600))] = rng.randint(256)
        elif kind == 2:
            d[rng.randint(len(d))] = rng.randint(256)
        else:
            d[rng.randint(min(len(d), 300))] ^= 1 << rng.randint(8)
        path.write_bytes(bytes(d))
        try:
            pil = Image.open(path)
            pil.load()
        except Exception:
            with pytest.raises(ValueError):
                port_image.read_picture(str(path))
            continue
        pic = port_image.read_picture(str(path))
        want = _pil_pixels(pil)
        assert pic.mode == pil.mode, name
        np.testing.assert_array_equal(pic.pixels, want, err_msg=name)
        agreed += 1
    assert agreed > 150


def _jpeg_files():
    """Baseline (Pillow's, one with restart intervals), progressive
    (Pillow's, and one with restarts), gray, arithmetic (sequential with
    and without restarts, progressive) and lossless (3 components; 1 with
    restarts) JPEGs."""
    rng = np.random.RandomState(7)
    yy, xx = np.mgrid[0:48, 0:64]
    rgb = np.stack([(xx * 4) % 256, (yy * 5) % 256, ((xx + yy) * 3) % 256], -1)
    rgb = np.clip(rgb + rng.randint(-20, 21, rgb.shape), 0, 255).astype(np.uint8)
    frame = W.frame_from_planes(W.rgb_to_ycc(rgb.astype(np.float64)),
                                [(2, 2), (1, 1), (1, 1)], 85)
    return {
        "baseline": _pil_save(rgb, "JPEG", quality=90),
        "progressive": _pil_save(rgb, "JPEG", quality=90, progressive=True),
        "gray": _pil_save(rgb, "JPEG", "L", quality=90),
        "baseline-restarts": W.jpeg_bytes(frame, restart=2),
        "progressive-restarts": W.jpeg_bytes(frame, progressive=True, restart=3),
        "arith": W.jpeg_bytes(frame, coding="arith"),
        "arith-restarts": W.jpeg_bytes(frame, coding="arith", restart=2),
        "arith-progressive": W.jpeg_bytes(frame, coding="arith",
                                          progressive=True),
        "lossless": W.lossless_bytes([rgb[..., i] for i in range(3)],
                                     predictor=4, adobe=0),
        "lossless-restarts": W.lossless_bytes([rgb[..., 0]], predictor=1,
                                              restart_rows=3),
    }


def _scan_spans(data):
    """(first, end) of each scan's entropy-coded bytes."""
    spans, pos = [], 2
    while pos < len(data) - 1:
        if data[pos] != 0xFF or data[pos + 1] in (0, 0xFF) or \
                0xD0 <= data[pos + 1] <= 0xD7:
            pos += 1
            continue
        if data[pos + 1] == 0xD9:
            break
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == 0xDA:
            start = end = pos + 2 + n
            while not (data[end] == 0xFF and data[end + 1] != 0
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
            spans.append((start, end))
            pos = end
        else:
            pos += 2 + n
    return spans


def test_jpeg_mutations_agree_with_pillow_in_both_decoders(tmp_path):
    """320 seeded mutations (a byte of a scan's entropy-coded data changed,
    a bit of it flipped, the file cut from a scan on, a byte changed
    anywhere) of baseline, progressive, arithmetic and lossless JPEGs, with
    and without restart intervals: the C++ stages read what Pillow
    (libjpeg-turbo) reads, as it reads it, and raise where it raises; the
    plain Python stage gives the same on every sequential Huffman file."""
    from nerf_pl_tpu_torch.data import jpeg
    rng = np.random.RandomState(21)
    files = _jpeg_files()
    names = sorted(files)
    spans = {name: _scan_spans(data) for name, data in files.items()}
    path = tmp_path / "mutated.jpg"
    outcomes = {"read": 0, "raised": 0}
    for _ in range(320):
        name = names[rng.randint(len(names))]
        d = bytearray(files[name])
        start, end = spans[name][rng.randint(len(spans[name]))]
        kind = rng.randint(4)
        if kind == 0:
            d[rng.randint(start, end)] = rng.randint(256)
        elif kind == 1:
            d[rng.randint(start, end)] ^= 1 << rng.randint(8)
        elif kind == 2:
            d = d[:rng.randint(start, len(d))]
        else:
            d[rng.randint(len(d))] = rng.randint(256)
        d = bytes(d)
        path.write_bytes(d)
        try:
            pil = Image.open(path)
            pil.load()
        except (OSError, SyntaxError):
            pil = None
        plains = (False, True) if name in ("baseline", "gray",
                                           "baseline-restarts") else (False,)
        for plain in plains:
            if pil is None:
                with pytest.raises(ValueError):
                    jpeg.decode(d, plain=plain)
                outcomes["raised"] += 1
                continue
            got, mode = jpeg.decode(d, plain=plain)
            assert mode == pil.mode, name
            np.testing.assert_array_equal(got, np.asarray(pil), err_msg=name)
            outcomes["read"] += 1
    assert outcomes["read"] > 200 and outcomes["raised"] > 50
