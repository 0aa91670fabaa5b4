"""The port's JPEG 2000 reader against Pillow 12.1 (OpenJPEG 2.5) and
through the JAX loader functions, bit for bit; its C++ stages against
their plain versions; and what it refuses.

Layouts Pillow's encoder writes: the modes ``L``, ``LA``, ``RGB``,
``RGBA`` and ``I;16``, JP2 and raw codestreams, reversible 5/3 and
irreversible 9/7, ``mct`` on and off, ``signed``, tiles with offsets, an
image offset, the five progressions, precinct and code-block sizes,
``num_resolutions`` 1-6, several quality layers (rates and dB), ``plt``
and ``comment``.  Layouts made by rewriting Pillow's files: precisions
1-16 (``Ssiz`` and ``ihdr``), ``CMYK`` and sYCC (``colr``), ``pclr``
palettes with repeated colours (``P`` and ``PA``), ``XLBox`` and
zero-length boxes, SOP markers before each packet and tiles split into
tile-parts at packet boundaries (both from the packet lengths of ``plt``),
tile-parts of several tiles interleaved, an ``ihdr`` whose component count
is not the codestream's.
"""
import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu_torch.data import image as port_image
from nerf_pl_tpu_torch.data import j2k_codestream as cs
from nerf_pl_tpu_torch.data import jpeg2000

import image_writers as W
from test_torch_port_images import WH, hold_loaders

W_, H_ = WH
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg2000")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = {k: v for k, v in json.load(_f).items() if not k.startswith("_")}


def _img(rng, shape, top=256):
    """Gradients with noise: smooth areas and busy ones."""
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (xx * 5 + yy * 3) * top // 256
    if len(shape) == 3:
        smooth = np.stack([np.roll(smooth, 7 * k, 1) for k in
                           range(shape[2])], -1)
    out = np.where(rng.rand(*shape) < 0.3, rng.randint(0, top, shape), smooth)
    return (out % top).astype(np.int64)


def save(arr, mode=None, **kw) -> bytes:
    b = io.BytesIO()
    if mode == "I;16":
        im = Image.fromarray(arr.astype(np.uint16)).convert("I;16")
    else:
        im = Image.fromarray(arr.astype(np.uint8), mode)
    im.save(b, "JPEG2000", **kw)
    return b.getvalue()


# --------------------------------------------------------------- cases
def _cases():
    rng = np.random.RandomState(18)
    g = _img(rng, (H_, W_))
    la = _img(rng, (H_, W_, 2))
    rgb = _img(rng, (H_, W_, 3))
    rgba = _img(rng, (H_, W_, 4))
    i16 = _img(rng, (H_, W_), 65536)
    out = []
    for mode, a in (("L", g), ("LA", la), ("RGB", rgb), ("RGBA", rgba)):
        out.append((f"{mode}", save(a, mode)))
        out.append((f"{mode}-97", save(a, mode, irreversible=True)))
        out.append((f"{mode}-j2k-layers", save(
            a, mode, no_jp2=True, quality_layers=[30, 12, 4])))
    out.append(("I16", save(i16, "I;16")))
    out.append(("I16-97-layers", save(i16, "I;16", irreversible=True,
                                      quality_layers=[20, 5])))
    out.append(("RGB-mct", save(rgb, "RGB", mct=1)))
    out.append(("RGB-97-mct-layers", save(rgb, "RGB", mct=1, irreversible=True,
                                          quality_layers=[40, 10, 3])))
    out.append(("RGB-97-db", save(rgb, "RGB", irreversible=True, mct=1,
                                  quality_mode="dB",
                                  quality_layers=[25, 32, 40])))
    out.append(("RGBA-mct-97", save(rgba, "RGBA", mct=1, irreversible=True,
                                    quality_layers=[8])))
    out.append(("L-signed", save(g, "L", signed=True)))
    out.append(("RGB-signed-97", save(rgb, "RGB", signed=True,
                                      irreversible=True, quality_layers=[9])))
    for order in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        out.append((f"RGB-{order}-precincts", save(
            rgb, "RGB", progression=order, precinct_size=(16, 16),
            codeblock_size=(8, 8), quality_layers=[20, 6], mct=1,
            tile_size=(24, 20), tile_offset=(3, 2), offset=(5, 7))))
    for n in range(1, 6):
        out.append((f"L-res{n}", save(g, "L", num_resolutions=n,
                                      irreversible=n % 2 == 0,
                                      quality_layers=[12])))
    # six resolutions need 32 samples a side at the lowest
    out.append(("RGB-res6", save(_img(rng, (64, 80, 3)), "RGB",
                                 num_resolutions=6, irreversible=True,
                                 quality_layers=[16])))
    out += [
        ("L-cblk-16x8", save(g, "L", codeblock_size=(16, 8))),
        ("L-cblk-4x64-97", save(g, "L", codeblock_size=(4, 64),
                                irreversible=True)),
        ("RGB-precinct-32x64", save(rgb, "RGB", precinct_size=(32, 64),
                                    codeblock_size=(16, 16))),
        ("RGB-tiles-offsets", save(rgb, "RGB", tile_size=(17, 13),
                                   tile_offset=(5, 3), offset=(11, 7),
                                   irreversible=True, mct=1)),
        ("L-tiles-odd", save(g, "L", tile_size=(7, 9), tile_offset=(1, 4),
                             offset=(3, 5), num_resolutions=3)),
        ("L-offset-odd-97", save(g, "L", offset=(3, 1), irreversible=True,
                                 tile_size=(W_ + 3, H_ + 1),
                                 num_resolutions=4)),
        ("RGB-plt-comment", save(rgb, "RGB", plt=True, comment="a comment")),
    ]
    # precisions 1-16 through SIZ (and ihdr), on the reversible gray file
    gray_j2k = save(g, "L", no_jp2=True)
    gray_jp2 = save(g, "L")
    _, gcode = W.jp2_parts(gray_jp2)
    for p in range(1, 17):
        out.append((f"prec{p}-j2k", W.with_precision(gray_j2k, p)))
    for p in (1, 2, 4, 7, 9, 12, 16):
        out.append((f"prec{p}-signed-jp2", W.rewrite_jp2(
            gray_jp2, W.with_precision(gcode, p, 1), bpc=(p - 1) | 0x80)))
    rgb97 = save(rgb, "RGB", irreversible=True)
    _, rcode = W.jp2_parts(rgb97)
    out.append(("RGB-prec12-97", W.rewrite_jp2(
        rgb97, W.with_precision(rcode, 12), bpc=11)))
    out.append(("I16-prec10", W.with_precision(
        save(i16, "I;16", no_jp2=True), 10)))
    # colour spaces through colr
    out.append(("CMYK", W.rewrite_jp2(save(rgba, "RGBA"), colr=12)))
    out.append(("sYCC", W.rewrite_jp2(save(rgb, "RGB"), colr=18)))
    out.append(("sYCC-97-alpha", W.rewrite_jp2(
        save(rgba, "RGBA", irreversible=True), colr=18)))
    # enumerated spaces OpenJPEG does not name, an ICC profile or no colr:
    # the space is unspecified, so the component count picks the unpacker
    out.append(("RGB-lab-space", W.rewrite_jp2(save(rgb, "RGB"), colr=14)))
    out.append(("RGBA-gray-space", W.rewrite_jp2(save(rgba, "RGBA"),
                                                 colr=17)))
    sub, code = W.jp2_parts(save(la, "LA"))
    out.append(("LA-no-colr", W.jp2_file(
        [b for b in sub if b[0] != b"colr"], code)))
    sub, code = W.jp2_parts(save(g, "L"))
    out.append(("L-icc", W.jp2_file(
        [(k, b"\2\0\0" + bytes(16)) if k == b"colr" else (k, v)
         for k, v in sub], code)))
    # palettes: repeated colours shift the indices (ImagePalette.getcolor)
    idx = _img(rng, (H_, W_), 24)
    pal = rng.randint(0, 256, (24, 3))
    pal[5], pal[9], pal[17] = pal[2], pal[2], pal[11]
    cmap = bytes([0, 0, 1, 0, 0, 0, 1, 1, 0, 0, 1, 2])
    out.append(("P-pclr", W.rewrite_jp2(save(idx, "L"), colr=16, extra=[
        (b"pclr", W.pclr_box(pal)), (b"cmap", cmap)])))
    pal4 = np.concatenate([pal, rng.randint(0, 256, (24, 1))], 1)
    pal4[3] = pal4[1]
    out.append(("PA-pclr-rgba", W.rewrite_jp2(
        save(np.stack([idx, _img(rng, (H_, W_))], -1), "LA"), colr=16,
        extra=[(b"pclr", W.pclr_box(pal4))])))
    # boxes: XLBox and zero-length jp2c, XLBox jp2h
    sub, code = W.jp2_parts(save(rgb, "RGB"))
    out.append(("xlbox-jp2c", W.jp2_file(
        sub, code, b"\0\0\0\1jp2c" + struct.pack(">Q", 16 + len(code)))))
    out.append(("zero-length-jp2c", W.jp2_file(sub, code, b"\0\0\0\0jp2c")))
    body = b"".join(W.box(k, v) for k, v in sub)
    out.append(("xlbox-jp2h", W.box(b"jP  ", b"\r\n\x87\n")
                + W.box(b"ftyp", b"jp2 \0\0\0\0jp2 ") + b"\0\0\0\1jp2h"
                + struct.pack(">Q", 16 + len(body)) + body
                + W.box(b"jp2c", code)))
    # SOP markers and tile-parts, from plt's packet lengths
    plt = save(rgb, "RGB", no_jp2=True, plt=True, tile_size=(16, 16),
               quality_layers=[25, 8], progression="RPCL", mct=1,
               irreversible=True)
    out.append(("sop-markers", W.with_sop(plt)))
    out.append(("tile-parts-3", W.split_tile_parts(plt, 3)))
    out.append(("tile-parts-interleaved", W.split_tile_parts(plt, 2, True)))
    # an ihdr that disagrees with the codestream's component count
    out.append(("ihdr-rgb-of-rgba", W.rewrite_jp2(save(rgba, "RGBA"), nc=3)))
    out.append(("ihdr-rgba-of-la", W.rewrite_jp2(save(la, "LA"), nc=4,
                                                 colr=17)))
    out.append(("ihdr-rgb-of-l", W.rewrite_jp2(save(g, "L"), nc=3)))
    return out


CASES = _cases()


def _hold_picture(path):
    pil = Image.open(path)
    pil.load()
    assert pil.format == "JPEG2000"
    want = np.asarray(pil)
    pic = port_image.read_picture(path)
    assert pic.mode == pil.mode
    assert pic.pixels.dtype == want.dtype and pic.pixels.shape == want.shape
    np.testing.assert_array_equal(pic.pixels, want)
    if pil.mode in ("P", "PA"):
        pal = np.array(pil.getpalette() or [], np.uint8).reshape(-1, 3)
        np.testing.assert_array_equal(pic.palette, pal[:len(pic.palette)])
    return pil


@pytest.mark.parametrize("name,data", CASES, ids=[c[0] for c in CASES])
def test_layout_matches_pillow_and_jax_loaders(tmp_path, name, data):
    path = str(tmp_path / f"{name}.jp2")
    with open(path, "wb") as f:
        f.write(data)
    pil = _hold_picture(path)
    hold_loaders(path, pil.size)


# -------------------------------------------------- C++ against plain
def _stages(code: bytes, plain: bool):
    """Every stage's output of every tile, decoded one way."""
    keep = []
    jpeg2000.decode_codestream(code, plain, keep=keep)
    return keep


def _corrupted(code: bytes, rng) -> bytes:
    """A few of the tile data's bytes replaced (the markers kept)."""
    body = bytearray(code)
    start = code.index(b"\xff\x93") + 2
    for k in rng.randint(start, len(code) - 2, 6):
        if body[k] != 0xFF and body[k - 1] != 0xFF:
            body[k] = rng.randint(0, 0xFF)
    return bytes(body)


STAGE_CASES = ["RGB-97-mct-layers", "RGBA-j2k-layers", "RGB-PCRL-precincts",
               "L-cblk-4x64-97", "sop-markers", "prec12-signed-jp2",
               "blender_rgba.j2k", "blender_rgb97.j2k"]


def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", STAGE_CASES)
def test_cpp_stages_equal_their_plain_versions(name):
    """tier-2, tier-1, the inverse DWT and the MCT in C++ against their
    plain versions stage by stage (float32 samples bit for bit), on a
    Pillow file (the two 64x64 fixtures that ``chip_smoke.py`` holds the
    stages on among them) and on copies with corrupted tile data, where
    both must give the same values or the same error."""
    data = _fixture(name) if name in DIGESTS else dict(CASES)[name]
    code = data if data[:4] == b"\xff\x4f\xff\x51" else W.jp2_parts(data)[1]
    rng = np.random.RandomState(len(name))
    bodies = [code] + [_corrupted(code, rng) for _ in range(3)]
    for k, body in enumerate(bodies):
        try:
            want = _stages(body, True)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                _stages(body, False)
            assert k, "the Pillow file must decode"
            continue
        assert jpeg2000.same_stages(want, _stages(body, False))


@pytest.mark.parametrize("tail", [0, 40], ids=["cut", "zeros-then-data"])
def test_zero_bitplane_tag_tree_ends_past_the_data(tmp_path, tail):
    """An 8x8 codestream of one code-block whose first packet header is cut
    right after its inclusion bit (``tail`` zero bytes, then the rest of
    the tile's data): every later bit reads 0, so the zero bit-plane tag
    tree's leaf resolves only at OpenJPEG's initial value, 999.  The
    decode ends, as Pillow's does, with the block all zeros: C++ and plain
    equal, the pixels Pillow's."""
    rng = np.random.RandomState(3)
    code = save(rng.randint(0, 256, (8, 8)), "L", no_jp2=True,
                num_resolutions=1)
    main, [(isot, segs, data)] = W.split_codestream(code)
    assert data[0] >> 6 == 0b11, "a non-empty packet, the block included"
    body = bytes([data[0] & 0xC0]) + (bytes(tail) + data[1:] if tail else b"")
    cut = W.join_codestream(main, [(isot, 0, 1, segs, body)])
    plain, native = _stages(cut, True), _stages(cut, False)
    assert jpeg2000.same_stages(plain, native)
    assert native[0][0][0][0] < 0, "Mb + 1 - 1000 zero bit-planes"
    path = tmp_path / "cut.j2k"
    path.write_bytes(cut)
    _hold_picture(str(path))


@pytest.mark.parametrize("side", [256, 60000])
def test_tiles_outside_the_opened_size_raise_before_decoding(
        tmp_path, monkeypatch, side):
    """A JP2 whose ``ihdr`` says 32x32 while its SIZ makes the image and
    its one tile ``side`` wide and high: Pillow's decoder refuses the tile
    before it decodes the tile's data (after the decompression-bomb check,
    which sees only ``ihdr``), and so does the port, naming the file,
    without decoding any tile."""
    rng = np.random.RandomState(8)
    jp2 = save(_img(rng, (32, 32, 3)), "RGB")
    sub, code = W.jp2_parts(jp2)
    main, parts = W.split_codestream(code)
    big = struct.pack(">II", side, side)
    main = [(m, b[:2] + big + b[10:18] + big + b[26:]) if m == 0xFF51
            else (m, b) for m, b in main]
    path = tmp_path / f"siz-{side}.jp2"
    path.write_bytes(W.jp2_file(sub, W.join_codestream(
        main, [(i, 0, 1, s, d) for i, s, d in parts])))
    if side == 256:  # Pillow's tile structures at 60000 would take GBs
        with pytest.raises(OSError, match="broken data stream"):
            Image.open(path).load()

    def no_decode(*args, **kw):
        raise AssertionError("a tile was decoded")

    monkeypatch.setattr(jpeg2000, "decode_tile", no_decode)
    with pytest.raises(ValueError,
                       match=rf"siz-{side}\.jp2: .*a tile outside the image"):
        port_image.read_picture(str(path))


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixtures_match_recorded_digests(name):
    """The committed fixtures that ``chip_smoke.py`` decodes (on a machine
    without Pillow) give the mode, shape and SHA-256 of Pillow's decode
    recorded in ``digests.json``."""
    pic = port_image.read_picture(os.path.join(FIXTURES, name))
    rec = DIGESTS[name]
    assert pic.mode == rec["mode"]
    assert list(pic.pixels.shape) == rec["shape"]
    assert hashlib.sha256(pic.pixels.tobytes()).hexdigest() == rec["sha256"]


def test_tier1_stages_on_random_streams():
    """The MQ decoder and coding passes on random bytes, every band
    orientation and odd block sizes: C++ and plain give the same
    coefficients."""
    rng = np.random.RandomState(2)
    for k in range(24):
        w, h = int(rng.randint(1, 19)), int(rng.randint(1, 19))
        orient = k % 4
        numbps, passes = int(rng.randint(1, 12)), int(rng.randint(1, 30))
        seg = rng.randint(0, 256, int(rng.randint(0, 60))).astype(np.uint8)
        seg[rng.rand(len(seg)) < 0.1] = 0xFF
        seg = seg.tobytes()
        want = jpeg2000.j2k_plain.tier1(seg, w, h, orient, numbps, passes)
        lay = cs.Layout([], [], [], np.array([[0, 0, 0, w, h, orient, 0]]),
                        np.zeros((0, 3), np.int32), np.zeros((0, 3), np.int32),
                        np.zeros(0, np.int32))
        plane = [np.zeros((h, w), np.int32)]
        jpeg2000.tier1(seg, lay, np.array([numbps]), np.array([passes]),
                       np.array([0]), np.array([len(seg)]), plane)
        np.testing.assert_array_equal(plane[0], want)


def test_ycc_tables_are_pillows():
    """Every (Cb, Cr) pair at several Y through the port's copy of
    ``ImagingConvertYCbCr2RGB`` and through Pillow's ``convert``."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in (0, 1, 90, 128, 254, 255):
        ycc = np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)
        want = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
        np.testing.assert_array_equal(jpeg2000.ycc_to_rgb(ycc), want)


# ------------------------------------------------------------ refusals
def _with_main_segment(code: bytes, marker: int, body: bytes) -> bytes:
    main, parts = W.split_codestream(code)
    return W.join_codestream(main + [(marker, body)],
                           [(i, 0, 1, s, d) for i, s, d in parts])


def _with_cod(code: bytes, scod_or=0, style=0) -> bytes:
    main, parts = W.split_codestream(code)
    main = [(m, bytes([b[0] | scod_or]) + b[1:8] + bytes([b[8] | style])
             + b[9:]) if m == 0xFF52 else (m, b) for m, b in main]
    return W.join_codestream(main, [(i, 0, 1, s, d) for i, s, d in parts])


def _refusals():
    rng = np.random.RandomState(4)
    rgb = _img(rng, (H_, W_, 3))
    code = save(rgb, "RGB", no_jp2=True)
    main, parts = W.split_codestream(code)
    siz = dict(main)[0xFF51]
    sub = siz[:36] + siz[36:39] + bytes([siz[39], 2, 1]) + siz[42:]
    out = {f"style-{n}": (_with_cod(code, style=b), n) for b, n in
           cs._STYLES.items()}
    out.update({
        "eph": (_with_cod(code, scod_or=4), "EPH"),
        "poc": (_with_main_segment(code, 0xFF5F, bytes([0, 0, 0, 1, 3, 2, 0])),
                "POC"),
        "ppm": (_with_main_segment(code, 0xFF60, b"\0" + bytes(8)), "PPM"),
        "rgn": (_with_main_segment(code, 0xFF5E, bytes([0, 0, 3])), "RGN"),
        "ppt": (W.join_codestream(main, [(i, 0, 1, s + [(0xFF61, b"\0\0")], d)
                                       for i, s, d in parts]), "PPT"),
        "subsampling": (W.join_codestream(
            [(m, sub if m == 0xFF51 else b) for m, b in main],
            [(i, 0, 1, s, d) for i, s, d in parts]), "subsampling"),
    })
    return out


def test_refusals_name_the_file_and_the_feature(tmp_path):
    """Each layout the port does not read raises ``ValueError`` naming the
    file and the feature."""
    for name, (body, feature) in _refusals().items():
        path = tmp_path / f"{name}.j2k"
        path.write_bytes(body)
        with pytest.raises(ValueError, match=rf"{name}\.j2k: .*{feature}"):
            port_image.read_picture(str(path))


def test_pillows_refusals_raise_naming_the_file(tmp_path):
    """Where Pillow's load or open raises (a truncated codestream, a colour
    space without an unpacker, no ``jp2h``), the port raises ``ValueError``
    naming the file; what Pillow's open rejects with ``SyntaxError`` falls
    through the other formats to none."""
    rng = np.random.RandomState(6)
    rgb = _img(rng, (H_, W_, 3))
    code = save(rgb, "RGB", no_jp2=True, quality_layers=[20, 5])
    jp2 = save(rgb, "RGB")
    sub, body = W.jp2_parts(jp2)
    five = bytearray(code)
    five[40:42] = b"\0\5"  # Csiz 5
    raises = {
        "cut-eoc.j2k": code[:-2], "cut-data.j2k": code[:-100],
        "cut-header.j2k": code[:60], "cut-jp2c.jp2": jp2[:-100],
        "cut-box.jp2": jp2[:50],
        "gray-space-rgb.jp2": W.rewrite_jp2(jp2, colr=17),
        "eycc.jp2": W.rewrite_jp2(jp2, colr=24),
        "l-as-srgb.jp2": W.rewrite_jp2(save(rgb[..., 0], "L"), colr=16),
        "ihdr-l-of-rgb.jp2": W.rewrite_jp2(jp2, nc=1),
        "no-jp2h.jp2": W.box(b"jP  ", b"\r\n\x87\n") + W.box(b"ftyp", b"jp2 "),
        "jp2h-past-end.jp2": W.box(b"jP  ", b"\r\n\x87\n")
        + b"\0\0\1\0jp2h" + bytes(20),
    }
    falls = {"csiz5.j2k": bytes(five),
             "ihdr-past-jp2h.jp2": W.box(b"jP  ", b"\r\n\x87\n") + W.box(
                 b"jp2h", b"\0\0\1\0ihdr" + bytes(12))}
    for name, data in {**raises, **falls}.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(Exception) as pil:
            Image.open(path).load()
        unidentified = isinstance(pil.value, Image.UnidentifiedImageError)
        assert unidentified == (name in falls), name
        match = r"not a PNG, .* or TGA file" if unidentified else ""
        with pytest.raises(ValueError, match=rf"{name.replace('.', r'\.')}: "
                           + match):
            port_image.read_picture(str(path))
