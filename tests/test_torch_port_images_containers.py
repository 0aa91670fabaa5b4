"""The port's TGA, ICO, CUR, DIB, QOI, SGI, PCX and PSD readers against
Pillow 12.1 and through the JAX loader functions, bit for bit;
``Image.open``'s order of formats and its moves from one to the next; and
the C++ run-length stages against their plain Python versions.

TGA: types 1-3 and 9-11 at every depth of ``MODES``, 16- and 24-bit colour
maps behind a first-entry offset, the image-ID field, both orientations
and right to left, raw packets running over rows.  DIB: a BMP without its
file header.  ICO: PNG payloads in
their own modes and sizes, DIB payloads of 1-32 bits with AND masks and
32-bit alpha, the entry Pillow picks among sizes and depths.  CUR: the
cursor Pillow picks, 32-bit at offset 22 and elsewhere.  QOI: every op,
an index op on an empty slot, a channels byte other than 3 or 4.  SGI: raw
and run-length, 1 and 2 bytes a sample, 1, 3 and 4 channels.  PCX: every
bits x planes layout Pillow maps, even and odd strides.  PSD: every colour
mode of ``MODES``, raw and PackBits, resources and a layer section.  Each
refusal Pillow makes raises ``ValueError`` naming the file.
"""
import io
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu_torch.data import image as port_image
from nerf_pl_tpu_torch.data import pcx, psd, qoi, rle, sgi, tga

import image_writers as W
from test_torch_port_images import WH, hold_loaders

H, WW = WH[1], WH[0]


def _img(rng, shape, top=256):
    """Runs, gradients and noise: every packet kind of the run-length
    coders."""
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = ((xx // 3 * 5 + yy * 3) * (top // 64 + 1)) % top
    if len(shape) == 3:
        smooth = np.repeat(smooth[..., None], shape[2], -1)
    out = np.where(rng.rand(*shape) < 0.5, smooth, rng.randint(0, top, shape))
    out[: h // 4] = out[0, 0]  # long runs
    return out.astype(np.int64)


def _pil_save(arr, fmt, mode=None, **kw):
    b = io.BytesIO()
    im = Image.fromarray(arr.astype(np.uint8))
    (im.convert(mode) if mode else im).save(b, fmt, **kw)
    return b.getvalue()


# ------------------------------------------------------------------ TGA
def _tga_cases(rng):
    rgb = _img(rng, (H, WW, 3)).astype(np.uint8)
    rgba = _img(rng, (H, WW, 4)).astype(np.uint8)
    gray = _img(rng, (H, WW)).astype(np.uint8)
    idx = _img(rng, (H, WW), 40).astype(np.uint8)
    words = rng.randint(0, 65536, (H, WW)).astype("<u2")
    words[:8] = words[0, 0]
    out = []
    for rle_ in (False, True):
        t = 8 if rle_ else 0
        tag = "rle" if rle_ else "raw"
        out += [(f"bgr24-{tag}", W.tga_bytes(rgb[..., ::-1], 2 + t, 24)),
                (f"bgra32-{tag}", W.tga_bytes(rgba[..., [2, 1, 0, 3]], 2 + t, 32)),
                (f"bgra15z-{tag}", W.tga_bytes(words.view(np.uint8).reshape(
                    H, WW, 2), 2 + t, 16)),
                (f"gray8-{tag}", W.tga_bytes(gray[..., None], 3 + t, 8)),
                (f"la16-{tag}", W.tga_bytes(rgba[..., ::3], 3 + t, 16)),
                (f"map24-{tag}", W.tga_bytes(
                    idx[..., None], 1 + t, 8, cmap=rng.randint(
                        0, 256, 40 * 3).astype(np.uint8).tobytes(),
                    cmap_depth=24)),
                (f"map16-first5-{tag}", W.tga_bytes(
                    idx[..., None], 1 + t, 8, cmap=rng.randint(
                        0, 65536, 35).astype("<u2").tobytes(),
                    cmap_depth=16, cmap_first=5))]
    bits = np.packbits(_img(rng, (H, WW), 2).astype(np.uint8), axis=1)
    out += [("gray1-raw", W.tga_bytes(bits[..., None], 3, 1, width=WW)),
            ("top-down", W.tga_bytes(rgb[..., ::-1], 10, 24, top_down=True)),
            ("right-to-left", W.tga_bytes(rgb[..., ::-1], 2, 24, rtl=True)),
            ("rtl-top-down-id", W.tga_bytes(rgba[..., [2, 1, 0, 3]], 10, 32,
                                            rtl=True, top_down=True,
                                            image_id=b"a TGA image id")),
            # a colour map on L and LA: Pillow's core image is P and PA
            ("gray-with-map", W.tga_bytes(idx[..., None], 3, 8, cmap=bytes(
                range(120)), cmap_depth=24)),
            ("la-with-map16", W.tga_bytes(np.stack([idx, gray], -1), 11, 16,
                                          cmap=bytes(range(80)),
                                          cmap_depth=16)),
            ("pillow-rle", _pil_save(rgb, "TGA", compression="tga_rle"))]
    # id length 10 with a colour-map depth but no map: PCX's _accept takes
    # it, its open fails (SyntaxError: bad image size), TGA reads it
    body = bytearray(W.tga_bytes(rgb[..., ::-1], 2, 24, image_id=b"0123456789"))
    body[7] = 24
    out.append(("pcx-accepted", bytes(body)))
    # a CUR directory of no cursors that is also a TGA header: CUR's open
    # fails (TypeError), TGA reads it
    out.append(("after-empty-cur", b"\0\0\2\0\0\0\0\0" + struct.pack(
        "<HHHHBB", 0, 0, WW, H, 24, 0) + rgb[::-1, :, ::-1].tobytes()))
    return out


# ------------------------------------------------------------- ICO, CUR
def _png(img, mode):
    return _pil_save(img, "PNG", mode)


def _ico_cases(rng):
    rgb = _img(rng, (H, WW, 3)).astype(np.uint8)
    alpha = _img(rng, (H, WW), 2).astype(np.uint8) * 255
    alpha8 = _img(rng, (H, WW)).astype(np.uint8)
    small = _img(rng, (16, 16, 3)).astype(np.uint8)
    out = []
    for bits in (1, 4, 8):
        n = 1 << bits
        pal = rng.randint(0, 256, (n, 3))
        out.append((f"ico-dib{bits}", W.icon_dir(
            [W.dib_bytes(_img(rng, (H, WW), n), bits, pal, alpha)], [WH],
            bpps=[bits])))
    bw = np.array([[0, 0, 0], [255, 255, 255]])
    out += [("ico-dib1-black-white", W.icon_dir([W.dib_bytes(
                _img(rng, (H, WW), 2), 1, bw, alpha)], [WH], bpps=[1])),
            ("ico-dib24", W.icon_dir([W.dib_bytes(rgb, 24, alpha=alpha)], [WH],
                                     bpps=[24])),
            ("ico-dib32", W.icon_dir([W.dib_bytes(rgb, 32, alpha=alpha8,
                                                  and_mask=False)], [WH])),
            ("ico-png-rgba", W.icon_dir([_png(np.concatenate(
                [rgb, alpha8[..., None]], -1), "RGBA")], [WH])),
            ("ico-png-l", W.icon_dir([_png(rgb, "L")], [WH], bpps=[8])),
            ("ico-png-p", W.icon_dir([_png(rgb, "P")], [WH], bpps=[8])),
            ("ico-png-p-trns", W.icon_dir([_pil_save(rgb, "PNG", "P",
                                                     transparency=3)], [WH])),
            ("ico-pillow", _pil_save(rgb, "ICO", sizes=[WH])),
            # the largest first, at its lowest depth: a 16x16 listed first,
            # then 32-bit and 8-bit icons of one size
            ("ico-pick", W.icon_dir(
                [W.dib_bytes(small, 32, alpha=alpha8[:16, :16]),
                 W.dib_bytes(rgb, 32, alpha=alpha8),
                 W.dib_bytes(_img(rng, (H, WW), 256), 8,
                             rng.randint(0, 256, (256, 3)), alpha)],
                [(16, 16), WH, WH], bpps=[32, 32, 8])),
            # the PNG's own size wins over the directory's
            ("ico-png-size", W.icon_dir([_png(rgb, "RGB")], [(64, 64)]))]
    pal = rng.randint(0, 256, (256, 3))
    out += [("cur-dib32-at-22", W.icon_dir([W.dib_bytes(
                rgb, 32, alpha=alpha8, and_mask=False)], [WH], kind=2)),
            ("cur-pick-dib32", W.icon_dir(
                [W.dib_bytes(small, 24), W.dib_bytes(rgb, 32, alpha=alpha8),
                 W.dib_bytes(small, 8, pal)], [(16, 16), WH, (16, 16)],
                kind=2, hotspots=[(1, 2), (3, 4), (5, 6)])),
            ("cur-dib8", W.icon_dir([W.dib_bytes(_img(rng, (H, WW), 256), 8,
                                                 pal)], [WH], kind=2)),
            ("cur-dib24", W.icon_dir([W.dib_bytes(rgb, 24)], [WH], kind=2)),
            # a DIB file: a BMP without its file header (Pillow's DIB)
            ("dib-8", W.bmp_bytes(_img(rng, (H, WW), 256), 8, pal)[14:]),
            ("dib-32-bitfields", W.bmp_bytes(np.concatenate(
                [rgb, alpha8[..., None]], -1), 32, header=124, masks=(
                    0xFF0000, 0xFF00, 0xFF, 0xFF000000))[14:])]
    return out


# ------------------------------------------------------------------ QOI
def _qoi_cases(rng):
    rgb = _img(rng, (H, WW, 3))
    rgba = _img(rng, (H, WW, 4))
    rgba[10:20, :, 3] = 255
    near = np.clip(rgb[:, :1] + np.cumsum(rng.randint(-3, 4, (H, WW, 3)), 1),
                   0, 255)  # diff and luma ops
    # an index op on an empty slot (0, 0, 0, 0 entering slot 0), then a run
    head = b"qoif" + struct.pack(">IIBB", WW, H, 4, 0)
    ops = bytes([0x07, 0xFE, 10, 20, 30, 0x00]) + bytes(
        [0xC0 | 61]) * ((WW * H - 3) // 62 + 1)
    return [("qoi-rgb", W.qoi_bytes(rgb.astype(np.uint8))),
            ("qoi-rgba", W.qoi_bytes(rgba.astype(np.uint8))),
            ("qoi-diff-luma", W.qoi_bytes(near.astype(np.uint8))),
            ("qoi-channels-5", W.qoi_bytes(rgb.astype(np.uint8), channels=5)),
            ("qoi-empty-index", head + ops + b"\0" * 7 + b"\1"),
            ("qoi-pillow", _pil_save(rgba, "QOI"))]


# ------------------------------------------------------------------ SGI
def _sgi_cases(rng):
    out = []
    for bpc in (1, 2):
        top = 1 << (8 * bpc)
        for z in (1, 3, 4):
            img = _img(rng, (H, WW, z), top)
            for rle_ in (False, True):
                out.append((f"sgi-{bpc}-{z}-{'rle' if rle_ else 'raw'}",
                            W.sgi_bytes(img, bpc, rle_)))
    out.append(("sgi-dimension-1", W.sgi_bytes(_img(rng, (H, WW)), 1, True,
                                               dimension=1)))
    return out


# ------------------------------------------------------------------ PCX
def _pcx_cases(rng):
    out = []
    pal16 = rng.randint(0, 256, (16, 3))
    pal256 = rng.randint(0, 256, (256, 3))
    ramp = np.repeat(np.arange(256)[:, None], 3, 1)
    for even in (True, False):
        tag = "even" if even else "odd"
        for planes in (1, 2, 4):
            out.append((f"pcx-1bit-{planes}-{tag}", W.pcx_bytes(
                _img(rng, (planes, H, WW), 2), 1, palette16=pal16,
                even_stride=even)))
    gray = _img(rng, (1, H, WW))
    out += [("pcx-8bit-no-palette", W.pcx_bytes(gray, 8)),
            ("pcx-8bit-ramp", W.pcx_bytes(gray, 8, palette256=ramp)),
            ("pcx-8bit-palette", W.pcx_bytes(gray, 8, palette256=pal256)),
            ("pcx-rgb", W.pcx_bytes(_img(rng, (3, H, WW)), 8)),
            ("pcx-origin", W.pcx_bytes(gray, 8, origin=(7, 3))),
            ("pcx-pillow-p", _pil_save(_img(rng, (H, WW, 3)), "PCX", "P"))]
    return out


# the widths at which PCX's row is packed (a row not a whole number of
# planes, longer than one) or not
PCX_ODD = [("pcx-rgb-w39", (39, 8), 8, 3), ("pcx-1bit-4-w3", (3, 8), 1, 4),
           ("pcx-1bit-2-w5", (5, 8), 1, 2)]


# ------------------------------------------------------------------ PSD
def _psd_cases(rng):
    out = []
    gray = _img(rng, (1, H, WW))
    for comp in (0, 1):
        tag = "packbits" if comp else "raw"
        out += [(f"psd-gray-{tag}", W.psd_bytes(gray, 1, compression=comp)),
                (f"psd-rgb-{tag}", W.psd_bytes(_img(rng, (3, H, WW)), 3,
                                               compression=comp)),
                (f"psd-bitmap-{tag}", W.psd_bytes(np.packbits(
                    _img(rng, (1, H, WW), 2).astype(np.uint8), axis=2), 0,
                    bits=1, compression=comp))]
    pal = rng.randint(0, 256, 768).astype(np.uint8).tobytes()
    res = W.psd_resource(1005, b"\0" * 16) + W.psd_resource(1039, b"icc", b"x")
    out += [("psd-rgba", W.psd_bytes(_img(rng, (4, H, WW)), 3)),
            ("psd-rgb-5ch", W.psd_bytes(_img(rng, (5, H, WW)), 3)),
            ("psd-cmyk", W.psd_bytes(_img(rng, (4, H, WW)), 4)),
            ("psd-cmyk-5ch-raw", W.psd_bytes(_img(rng, (5, H, WW)), 4,
                                             compression=0)),
            ("psd-indexed", W.psd_bytes(_img(rng, (1, H, WW)), 2,
                                        color_data=pal)),
            ("psd-indexed-no-palette", W.psd_bytes(_img(rng, (1, H, WW)), 2)),
            ("psd-gray-2ch", W.psd_bytes(_img(rng, (2, H, WW)), 1)),
            ("psd-multichannel", W.psd_bytes(_img(rng, (3, H, WW)), 7)),
            ("psd-duotone", W.psd_bytes(gray, 8, color_data=b"\0" * 30)),
            ("psd-resources-layers", W.psd_bytes(
                _img(rng, (3, H, WW)), 3, resources=res,
                layers=struct.pack(">I", 6) + b"layers")),
            ("psd-lab", W.psd_bytes(_img(rng, (3, H, WW)), 9))]
    return out


def _cases():
    rng = np.random.RandomState(17)
    return ([("tga-" + n, d) for n, d in _tga_cases(rng)] + _ico_cases(rng)
            + _qoi_cases(rng) + _sgi_cases(rng) + _pcx_cases(rng)
            + _psd_cases(rng))


CASES = _cases()


def _hold_picture(path, pil):
    """The port's picture against Pillow's image: mode, pixels, palette."""
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
    return pic


@pytest.mark.parametrize("name,data", CASES, ids=[c[0] for c in CASES])
def test_layout_matches_pillow_and_jax_loaders(tmp_path, name, data):
    path = str(tmp_path / f"{name}.img")
    with open(path, "wb") as f:
        f.write(data)
    pil = Image.open(path)
    pil.load()
    assert pil.format == name.split("-")[0].upper(), pil.format
    pic = _hold_picture(path, pil)
    if pic.mode == "LAB":  # Pillow converts LAB through LittleCMS
        for mode in ("RGB", "RGBA"):
            np.testing.assert_array_equal(port_image.convert(pic, mode),
                                          np.asarray(pil.convert(mode)))
    hold_loaders(path, pil.size)


@pytest.mark.parametrize("name,wh,bits,planes", PCX_ODD,
                         ids=[c[0] for c in PCX_ODD])
def test_pcx_rows_packed_as_pillow(tmp_path, name, wh, bits, planes):
    """At these widths PcxDecode packs each row's planes (or does not) before
    unpacking them; a header stride that is odd and one made even.  (An odd
    width has no half of its aspect, which ``_load_rgb`` asserts: the
    pictures are held, the loaders on the even widths above.)"""
    rng = np.random.RandomState(3)
    for even in (True, False):
        path = tmp_path / f"{name}-{even}.pcx"
        path.write_bytes(W.pcx_bytes(_img(rng, (planes, wh[1], wh[0]),
                                          1 << bits), bits, even_stride=even,
                                     palette16=rng.randint(0, 256, (16, 3))))
        _hold_picture(str(path), Image.open(path))


def _refusals(rng):
    rgb = _img(rng, (H, WW, 3)).astype(np.uint8)
    gray = _img(rng, (H, WW)).astype(np.uint8)
    run_over = W.tga_bytes(rgb[..., ::-1], 10, 24)[:18] + bytes(
        [0x80 | 50]) + bytes(3)
    cur_none = W.icon_dir([], [], kind=2) + bytes(40)
    psb = bytearray(W.psd_bytes(_img(rng, (1, H, WW)), 1))
    psb[5] = 2
    sgi_z2 = W.sgi_bytes(_img(rng, (H, WW, 2)), 1)
    sgi_comp2 = bytearray(W.sgi_bytes(gray, 1))
    sgi_comp2[2] = 2
    return {
        "tga-type2-depth8.tga": W.tga_bytes(gray[..., None], 2, 8),
        "tga-no-map.tga": W.tga_bytes(gray[..., None], 1, 8),
        "tga-rgb-with-map.tga": W.tga_bytes(rgb[..., ::-1], 2, 24, cmap=bytes(
            range(48)), cmap_depth=24),
        "tga-map32.tga": W.tga_bytes(gray[..., None], 1, 8, cmap=bytes(
            range(256)) * 4, cmap_depth=32),
        "tga-map15.tga": W.tga_bytes(gray[..., None], 1, 8, cmap=bytes(
            512), cmap_depth=15),
        "tga-rle-gray1.tga": W.tga_bytes(np.packbits(gray > 9, axis=1)[
            ..., None], 11, 8)[:16] + b"\x01\x00" + bytes(20),
        "tga-run-over-row.tga": run_over,
        "tga-cut.tga": W.tga_bytes(rgb[..., ::-1], 2, 24)[:500],
        # PCX takes it, finds a valid size and 0 bits: Pillow raises there
        "tga-pcx-raises.tga": W.tga_bytes(rgb[..., ::-1], 2, 24,
                                          image_id=b"0123456789"),
        "cur-none.cur": cur_none,
        "qoi-cut.qoi": W.qoi_bytes(rgb)[:200],
        "qoi-empty.qoi": b"qoif" + struct.pack(">IIBB", 0, H, 3, 0) + bytes(8),
        "sgi-2-channels.sgi": sgi_z2,
        "sgi-compression-2.sgi": bytes(sgi_comp2),
        "pcx-2bit.pcx": W.pcx_bytes(_img(rng, (1, H, WW), 4), 2),
        "pcx-4bit.pcx": W.pcx_bytes(_img(rng, (1, H, WW), 16), 4),
        "pcx-version-3.pcx": W.pcx_bytes(_img(rng, (1, H, WW)), 8, version=3),
        "pcx-bad-size.pcx": W.pcx_bytes(_img(rng, (1, H, WW)), 8)[:4]
        + struct.pack("<4H", 9, 0, 3, 5) + bytes(200),
        "pcx-cut.pcx": W.pcx_bytes(_img(rng, (1, H, WW)), 8)[:300],
        "psd-16bit.psd": W.psd_bytes(_img(rng, (1, H, WW)).astype(
            ">u2").view(np.uint8).reshape(1, H, 2 * WW), 1, bits=16),
        "psd-too-few.psd": W.psd_bytes(_img(rng, (2, H, WW)), 3),
        "psd-zip.psd": W.psd_bytes(_img(rng, (1, H, WW)), 1, compression=2),
        "psd-psb.psd": bytes(psb),
        "psd-cut.psd": W.psd_bytes(_img(rng, (3, H, WW)), 3)[:-100],
    }


def test_refusals_name_the_file(tmp_path):
    """What Pillow refuses (its open or load raises, or no format takes the
    file) raises ``ValueError`` naming the file; the formats that fall
    through to the next do so as in ``Image.open``."""
    for name, body in _refusals(np.random.RandomState(5)).items():
        path = tmp_path / name
        path.write_bytes(body)
        with pytest.raises(Exception):
            Image.open(path).load()
        with pytest.raises(ValueError, match=rf"{name.replace('.', r'\.')}: "):
            port_image.read_picture(str(path))


def test_fall_through_order_is_pillows(tmp_path):
    """``Image.ID`` in a fresh process after ``Image.open`` (the pre-init
    plugins, then ``init``'s) is the port's table, and what no format takes
    is named by its first bytes."""
    path = tmp_path / "a.png"
    path.write_bytes(W.png_bytes(np.zeros((2, 2)), 8, 0))
    code = ("from PIL import Image\nImage.open(%r).load()\n"
            "open(%r, 'wb').write(b'junk!' * 40)\n"
            "try:\n    Image.open(%r)\nexcept Exception:\n    pass\n"
            "print(' '.join(Image.ID))" % (str(path), str(tmp_path / "j"),
                                          str(tmp_path / "j")))
    ids = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split()
    assert ids == [n for n, _, _ in port_image._FORMATS]
    with pytest.raises(ValueError, match=r"j: not a PNG, .* or TGA file"):
        port_image.read_picture(str(tmp_path / "j"))


def test_rle_stages_equal_their_plain_versions():
    """Each C++ stage of ``csrc/rle_decode.cpp`` (and PSD's PackBits rows
    of ``csrc/tiff_decode.cpp``) against its plain Python version on
    seeded streams: the writers' files, and random bytes, where both must
    give the same pixels or the same error."""
    rng = np.random.RandomState(9)

    def same(plain, native, *args):
        try:
            want = plain(*args)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                native(*args)
            return 0
        np.testing.assert_array_equal(native(*args), want)
        return 1

    decoded = 0
    for k in range(40):
        w, h = rng.randint(1, 40, 2)
        depth = int(rng.choice([1, 2, 3, 4]))
        img = _img(rng, (h, w, depth)).astype(np.uint8)
        body = W.tga_bytes(img, 10, 8 * depth)[18:]
        junk = rng.randint(0, 256, rng.randint(0, 300)).astype(np.uint8).tobytes()
        for data in (body, junk, body[:len(body) // 2]):
            decoded += same(tga.rle_plain, rle.tga_rle, data, w, h, depth)
        planes = int(rng.choice([1, 3]))
        body = W.pcx_bytes(_img(rng, (planes, h, w)), 8)[128:]
        stride = w + w % 2
        for data in (body, junk):
            decoded += same(pcx.rle_plain, rle.pcx_rle, data, planes * stride, h)
        bpc, z = int(rng.choice([1, 2])), int(rng.choice([1, 3, 4]))
        body = W.sgi_bytes(_img(rng, (h, w, z), 1 << (8 * bpc)), bpc, True)
        tabs = np.frombuffer(body[512:512 + 8 * h * z], ">u4").astype(np.uint32)
        lens = tabs[h * z:].copy()
        if k % 4 == 3:
            lens[rng.randint(0, h * z)] = 1  # a row without its 0 count
        decoded += same(sgi.rle_plain, rle.sgi_rle, body, w, h, z, bpc,
                        tabs[:h * z], lens)
        body = W.qoi_bytes(_img(rng, (h, w, 4)).astype(np.uint8))[14:]
        for data in (body, junk, body[:len(body) // 2]):
            decoded += same(qoi.ops_plain, rle.qoi, data, w * h)
        body = b"".join(W.packbits(bytes(r)) for r in img.reshape(h, -1))
        for data in (body, junk, body[:len(body) // 2]):
            decoded += same(psd.packbits_plain, psd.packbits, data,
                            w * depth, h)
    assert decoded > 150
