"""The port's PPM, BMP and GIF readers and its modes ``I``, ``F``,
``I;16B`` and ``PA`` against Pillow and through the JAX loader functions,
bit for bit.

Netpbm: every header of ``PpmImagePlugin.MODES``, plain and raw, with
comments and maxvals of 1, 15, 255, 256, 1023 and 65535.  BMP: core, info,
v4 and v5 headers; 1, 4 and 8-bit palettes (gray ramps and black-white
ones included), 16-bit 5-5-5 and 5-6-5, 24 and 32 bits with and without
``BI_BITFIELDS`` (alpha masks), RLE8 and RLE4 with delta escapes, top-down
rows.  GIF: global and local tables, identity gray tables, interlace, the
transparency index, a frame offset on its screen and one reaching past it,
LZW tables that fill and clear.  Then resize and convert in the new modes
against Pillow, and what raises.
"""
import io

import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu_torch.data import image as port_image
from nerf_pl_tpu_torch.data.image import Picture, convert, gaussian_blur, resize

import image_writers as W
from test_torch_port_images import WH, hold_loaders


def _img(rng, shape, top=256):
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = ((xx * 5 + yy * 3) * (top // 64 + 1)) % top
    if len(shape) == 3:
        smooth = np.repeat(smooth[..., None], shape[2], -1)
    return np.where(rng.rand(*shape) < 0.5, smooth,
                    rng.randint(0, top, shape)).astype(np.int64)


def _ppm_cases(rng):
    h, w = WH[1], WH[0]
    out = []
    bits = (_img(rng, (h, w)) & 1).astype(np.uint8)
    out += [("p1", W.ppm_bytes(bits, b"P1", comment=True)),
            ("p4", W.ppm_bytes(bits, b"P4"))]
    for maxval in (1, 15, 255, 256, 1023, 65535):
        gray = _img(rng, (h, w), maxval + 1)
        rgb = _img(rng, (h, w, 3), maxval + 1)
        out += [(f"p2-{maxval}", W.ppm_bytes(gray, b"P2", maxval, True)),
                (f"p5-{maxval}", W.ppm_bytes(gray, b"P5", maxval)),
                (f"p3-{maxval}", W.ppm_bytes(rgb, b"P3", maxval)),
                (f"p6-{maxval}", W.ppm_bytes(rgb, b"P6", maxval, True))]
    f = (rng.randn(h, w) * 300).astype(np.float32)
    out.append(("pf-le", W.ppm_bytes(f, b"Pf")))
    out.append(("pf-be", b"Pf\n%d %d\n2.5\n" % (w, h)
                + f[::-1].astype(">f4").tobytes()))
    raw = _img(rng, (h, w, 4)).astype(np.uint8)
    for magic in (b"P0CMYK", b"PyRGBA", b"PyCMYK"):
        out.append((magic.decode().lower(), magic + b" %d %d 255\n" % (w, h)
                    + raw.tobytes()))
    out.append(("pyp", b"PyP\n%d %d\n255\n" % (w, h)
                + raw[..., 0].tobytes()))
    return out


def _bmp_cases(rng):
    h, w = WH[1], WH[0]
    out = []
    rgb = _img(rng, (h, w, 3)).astype(np.uint8)
    rgba = _img(rng, (h, w, 4)).astype(np.uint8)
    for bits in (1, 4, 8):
        n = 1 << bits
        idx = _img(rng, (h, w), n)
        pal = rng.randint(0, 256, (n, 3))
        out.append((f"pal{bits}", W.bmp_bytes(idx, bits, pal)))
        out.append((f"pal{bits}-core", W.bmp_bytes(idx, bits, pal, header=12)))
        out.append((f"pal{bits}-v5-topdown", W.bmp_bytes(idx, bits, pal,
                                                         header=124,
                                                         top_down=True)))
        if bits in (4, 8):
            runs = np.repeat(idx[:, ::4], 4, 1)[:, :w]
            out.append((f"rle{bits}", W.bmp_bytes(runs, bits, pal, rle=True)))
            out.append((f"rle{bits}-noise", W.bmp_bytes(idx, bits, pal,
                                                        rle=True)))
    ramp = np.repeat(np.arange(256)[:, None], 3, 1)
    out.append(("gray-ramp", W.bmp_bytes(_img(rng, (h, w)), 8, ramp)))
    out.append(("black-white", W.bmp_bytes(_img(rng, (h, w), 2), 1,
                                           np.array([[0] * 3, [255] * 3]))))
    out.append(("rgb24", W.bmp_bytes(rgb, 24)))
    out.append(("rgb24-v4", W.bmp_bytes(rgb, 24, header=108)))
    out.append(("rgb32", W.bmp_bytes(rgb, 32)))
    out.append(("rgb16-555", W.bmp_bytes(rgb, 16)))
    out.append(("rgb16-565", W.bmp_bytes(rgb, 16, masks=(0xF800, 0x7E0, 0x1F))))
    for masks in ((0xFF0000, 0xFF00, 0xFF, 0), (0xFF0000, 0xFF00, 0xFF,
                                                0xFF000000),
                  (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                  (0xFF000000, 0xFF0000, 0xFF00, 0xFF)):
        tag = "-".join(f"{m:x}" for m in masks)
        for header in (40, 124):
            out.append((f"bitfields32-{tag}-h{header}", W.bmp_bytes(
                rgba, 32, masks=masks, header=header)))
    # RLE8 with a delta escape: Pillow reads its two bytes and the next two
    idx = _img(rng, (h, w), 256)
    pal = rng.randint(0, 256, (256, 3))
    body = bytearray(W.bmp_bytes(idx, 8, pal, rle=True))
    offset = int.from_bytes(body[10:14], "little")
    delta = b"\x00\x02\x03\x01\x02\x00" + b"\x05\x07" * 3
    out.append(("rle8-delta", bytes(body[:offset]) + delta
                + bytes(body[offset:])))
    return out


def _gif_cases(rng):
    h, w = WH[1], WH[0]
    out = []
    for n in (2, 16, 256):
        idx = _img(rng, (h, w), n)
        pal = rng.randint(0, 256, (n, 3))
        out += [(f"global{n}", W.gif_bytes(idx, pal)),
                (f"local{n}-interlace", W.gif_bytes(idx, pal, local=True,
                                                    interlace=True)),
                (f"global{n}-trns", W.gif_bytes(idx, pal, transparency=1))]
    ramp = np.repeat(np.arange(256)[:, None], 3, 1)
    gray = _img(rng, (h, w), 256)
    out.append(("gray-ramp-l", W.gif_bytes(gray, ramp)))
    out.append(("no-table-l", W.gif_bytes(gray, None)))
    small = _img(rng, (h - 10, w - 12), 16)
    pal = rng.randint(0, 256, (16, 3))
    out.append(("offset", W.gif_bytes(small, pal, screen=WH, offset=(5, 7))))
    out.append(("offset-trns", W.gif_bytes(small, pal, screen=WH,
                                           offset=(12, 10), transparency=3)))
    out.append(("gif87a", W.gif_bytes(_img(rng, (h, w), 16), pal,
                                      version=b"GIF87a")))
    return out


def _cases():
    rng = np.random.RandomState(0)
    return ([("ppm-" + n, d, ".ppm") for n, d in _ppm_cases(rng)]
            + [("bmp-" + n, d, ".bmp") for n, d in _bmp_cases(rng)]
            + [("gif-" + n, d, ".gif") for n, d in _gif_cases(rng)])


CASES = _cases()


@pytest.mark.parametrize("name,data,ext", CASES, ids=[c[0] for c in CASES])
def test_layout_matches_pillow_and_jax_loaders(tmp_path, name, data, ext):
    path = str(tmp_path / f"{name}{ext}")
    with open(path, "wb") as f:
        f.write(data)
    try:
        pil = Image.open(path)
        pil.load()
    except OSError:  # an alpha mask a 40-byte header cannot hold
        with pytest.raises(ValueError, match=rf"{name}{ext}: unsupported"):
            port_image.read_picture(path)
        return
    want = np.asarray(pil)
    if pil.mode == "1":
        want = want.astype(np.uint8) * 255
    pic = port_image.read_picture(path)
    assert pic.mode == pil.mode
    assert pic.pixels.dtype == want.dtype and pic.pixels.shape == want.shape
    np.testing.assert_array_equal(pic.pixels, want)
    if pic.mode == "P":
        pal = np.array(pil.getpalette() or [], np.uint8).reshape(-1, 3)
        n = min(len(pal), len(pic.palette))
        np.testing.assert_array_equal(pic.palette[:n], pal[:n])
    assert pic.transparency == pil.info.get("transparency")
    hold_loaders(path)


def test_gif_lzw_table_fills_and_clears(tmp_path):
    """A noisy 8-bit GIF large enough that the writer's table fills (4096
    codes) and clears, read as Pillow reads it."""
    rng = np.random.RandomState(5)
    idx = rng.randint(0, 256, (90, 120))
    pal = rng.randint(0, 256, (256, 3))
    path = tmp_path / "full.gif"
    path.write_bytes(W.gif_bytes(idx, pal))
    np.testing.assert_array_equal(port_image.read_picture(str(path)).pixels,
                                  np.asarray(Image.open(path)))


@pytest.mark.parametrize("mode", ["I", "F", "I;16B"])
def test_resize_in_new_modes_matches_pillow(mode):
    """LANCZOS in ``I`` and ``F`` (double sums; ``I`` rounded, past int32
    as C's cast) and ``I;16B`` (Pillow's byte-swapped 16-bit passes) over
    random sizes up and down, on signed values and values past 2^24."""
    rng = np.random.RandomState(31)
    for _ in range(10):
        w, h = rng.randint(1, 60, 2)
        size = tuple(int(v) for v in rng.randint(1, 80, 2))
        if mode == "I":
            img = rng.randint(-2 ** 31, 2 ** 31, (h, w)).astype(np.int32)
            img[::3] //= 1 << 8  # values past 2^24, and smaller ones
        elif mode == "F":
            img = (rng.randn(h, w) * 1e8).astype(np.float32)
        else:
            img = rng.randint(0, 65536, (h, w)).astype(np.uint16)
        pil = (Image.frombytes(mode, (w, h), img.astype(">u2").tobytes())
               if mode == "I;16B" else Image.fromarray(img))
        assert pil.mode == mode
        want = np.asarray(pil.resize(size, Image.LANCZOS))
        got = resize(Picture(img, mode), size).pixels
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=f"{(w, h)} -> {size}")


@pytest.mark.parametrize("mode", ["I", "F", "I;16B", "PA"])
def test_convert_and_blur_in_new_modes_match_pillow(mode):
    """``convert`` to ``L``, ``RGB`` and ``RGBA`` clips ``I`` and ``F``
    (truncating ``F``) and ``I;16B`` to 0-255, and takes ``PA`` through its
    palette; ``GaussianBlur`` refuses all four, as Pillow does."""
    rng = np.random.RandomState(7)
    if mode == "I":
        img = rng.randint(-600, 600, (5, 9)).astype(np.int32)
        pil = Image.fromarray(img)
    elif mode == "F":
        img = (rng.randn(5, 9) * 300).astype(np.float32)
        img[0, :5] = [np.nan, np.inf, -np.inf, 254.99, 0.5]
        pil = Image.fromarray(img)
    elif mode == "I;16B":
        img = rng.randint(0, 700, (5, 9)).astype(np.uint16)
        pil = Image.frombytes(mode, (9, 5), img.astype(">u2").tobytes())
    else:
        img = rng.randint(0, 256, (5, 9, 2)).astype(np.uint8)
        pil = Image.frombytes(mode, (9, 5), img.tobytes())
        pal = rng.randint(0, 256, (256, 3)).astype(np.uint8)
        pil.putpalette(pal.reshape(-1).tolist())
    pic = Picture(img, mode, pal if mode == "PA" else None)
    for target in ("L", "RGB", "RGBA"):
        np.testing.assert_array_equal(convert(pic, target),
                                      np.asarray(pil.convert(target)))
    with pytest.raises(ValueError, match="wrong mode"):
        from PIL import ImageFilter
        pil.filter(ImageFilter.GaussianBlur(1))
    with pytest.raises(ValueError, match="wrong mode"):
        gaussian_blur(pic, 1)


def _with_byte(data: bytes, at: int, value: int) -> bytes:
    return data[:at] + bytes([value]) + data[at + 1:]


def test_refusals_name_the_file(tmp_path):
    """Corrupt files of each container raise in Pillow and in the port,
    the port's message naming the file; a BMP whose gray palette sits on
    4-bit data (Pillow reads it as 8-bit samples) raises in the port."""
    rng = np.random.RandomState(9)
    idx = _img(rng, (WH[1], WH[0]), 16)
    files = {
        "cut.ppm": W.ppm_bytes(idx, b"P5")[:-100],
        "maxval.ppm": b"P5 4 4 70000\n" + bytes(32),
        "cut.bmp": W.bmp_bytes(idx, 8, rng.randint(0, 256, (256, 3)))[:500],
        "depth.bmp": _with_byte(W.bmp_bytes(idx, 8, rng.randint(
            0, 256, (256, 3))), 28, 7),  # biBitCount 7
        "no-frame.gif": W.gif_bytes(idx, rng.randint(0, 256, (16, 3)))[:30]
        + b";",
    }
    for name, body in files.items():
        path = tmp_path / name
        path.write_bytes(body)
        with pytest.raises(Exception):
            Image.open(path).load()
        with pytest.raises(ValueError, match=rf"{name.replace('.', r'\.')}: "):
            port_image.read_picture(str(path))
    ramp4 = tmp_path / "ramp4.bmp"
    ramp4.write_bytes(W.bmp_bytes(idx, 4, np.repeat(np.arange(16)[:, None], 3, 1)))
    with pytest.raises(ValueError, match=r"ramp4\.bmp: a gray palette on 4-bit"):
        port_image.read_picture(str(ramp4))


def test_containers_open_by_content(tmp_path):
    """A WebP, a TIFF, a BMP, a GIF and a PPM under one another's names load
    as Pillow opens them."""
    rng = np.random.RandomState(11)
    rgb = _img(rng, (WH[1], WH[0], 3)).astype(np.uint8)
    bodies = []
    for fmt, kw in (("WEBP", dict(lossless=True)), ("TIFF", {}), ("BMP", {}),
                    ("GIF", {}), ("PPM", {})):
        b = io.BytesIO()
        Image.fromarray(rgb).save(b, fmt, **kw)
        bodies.append(b.getvalue())
    for i, name in enumerate(("a.png", "b.jpg", "c.webp", "d.tif", "e.bmp")):
        path = tmp_path / name
        path.write_bytes(bodies[i])
        hold_loaders(str(path))
