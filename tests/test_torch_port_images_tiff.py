"""The port's TIFF reader against Pillow (its own raw decoder and libtiff)
and through the JAX loader functions, bit for bit.

Every ``TiffImagePlugin.OPEN_INFO`` layout in each byte order it lists,
written by ``tests/image_writers.py`` under a rotation of the compressions
(none, LZW, Deflate, Adobe Deflate, PackBits, LZMA) and predictors 2 and 3;
then strips (a short last one), tiles (padded edges), separate planes,
BigTIFF, fill order 2, libtiff's old-style LZW codes and JPEG-in-TIFF
(Pillow's, and YCbCr 4:2:0 strips and tiles whose tables are only in
``JPEGTables``); then what raises.
"""
import ctypes
import io

import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu_torch.data import image as port_image
from nerf_pl_tpu_torch.data import tiff

import image_writers as W
from test_torch_port_images import WH, hold_loaders

# photometric, bits, samples, extra samples, sample format, byte orders
LAYOUTS = [
    (0, 1, 1, (), 1, "both"), (1, 1, 1, (), 1, "both"),
    (0, 2, 1, (), 1, "both"), (1, 2, 1, (), 1, "both"),
    (0, 4, 1, (), 1, "both"), (1, 4, 1, (), 1, "both"),
    (0, 8, 1, (), 1, "both"), (1, 8, 1, (), 1, "both"),
    (1, 8, 1, (), 2, "both"), (1, 12, 1, (), 1, "II"),
    (0, 16, 1, (), 1, "II"), (1, 16, 1, (), 1, "both"),
    (1, 16, 1, (), 2, "both"), (0, 32, 1, (), 3, "both"),
    (1, 32, 1, (), 1, "II"), (1, 32, 1, (), 2, "both"),
    (1, 32, 1, (), 3, "both"), (1, 8, 2, (2,), 1, "both"),
    (2, 8, 3, (), 1, "both"), (2, 8, 4, (), 1, "both"),
    (2, 8, 4, (0,), 1, "both"), (2, 8, 5, (0, 0), 1, "both"),
    (2, 8, 6, (0, 0, 0), 1, "both"), (2, 8, 4, (1,), 1, "both"),
    (2, 8, 5, (1, 0), 1, "both"), (2, 8, 6, (1, 0, 0), 1, "both"),
    (2, 8, 4, (2,), 1, "both"), (2, 8, 5, (2, 0), 1, "both"),
    (2, 8, 6, (2, 0, 0), 1, "both"), (2, 8, 4, (999,), 1, "both"),
    (2, 16, 3, (), 1, "both"), (2, 16, 4, (), 1, "both"),
    (2, 16, 4, (0,), 1, "both"), (2, 16, 4, (1,), 1, "both"),
    (2, 16, 4, (2,), 1, "both"), (3, 1, 1, (), 1, "both"),
    (3, 2, 1, (), 1, "both"), (3, 4, 1, (), 1, "both"),
    (3, 8, 1, (), 1, "both"), (3, 8, 2, (0,), 1, "both"),
    (3, 8, 2, (2,), 1, "both"), (5, 8, 4, (), 1, "both"),
    (5, 8, 5, (0,), 1, "both"), (5, 8, 6, (0, 0), 1, "both"),
    (5, 16, 4, (), 1, "both"), (6, 8, 1, (), 1, "both"),
]
COMPRESSIONS = [1, 5, 8, 32946, 32773, 34925]


def _samples(rng, bits, spp, fmt, h=WH[1], w=WH[0]):
    """Runs and gradients as well as noise, so every codec has work."""
    yy, xx = np.mgrid[0:h, 0:w]
    if fmt == 3:
        s = (xx[..., None] * 3.5 - yy[..., None] * 100.25
             + rng.randn(h, w, spp) * 1e5).astype(np.float32)
        s[0, :4, 0] = [np.inf, -np.inf, 1e30, -0.0]
        return s
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if fmt == 2 else (0, 1 << bits)
    noise = rng.randint(lo, hi, (h, w, spp)).astype(np.int64)
    smooth = (((xx + yy) * 37) % (hi - lo) + lo)[..., None]
    s = np.where(rng.rand(h, w, 1) < 0.5, smooth, noise)
    return s.astype(np.uint64 if bits == 32 and fmt == 1 else np.int64)


def _layout_cases():
    rng = np.random.RandomState(0)
    out = []
    for i, (ph, bits, spp, extra, fmt, orders) in enumerate(LAYOUTS):
        for j, order in enumerate(("II", "MM") if orders == "both" else (orders,)):
            s = _samples(rng, bits, spp, fmt)
            if ph == 2 and extra and extra[0] == 1:  # associated: c <= a
                s[..., :3] = np.minimum(s[..., :3], s[..., 3:4])
            comp = COMPRESSIONS[(i + j) % len(COMPRESSIONS)]
            pred = 1
            if comp in (5, 8, 34925) and bits in (8, 16, 32) and (i + j) % 2:
                pred = 3 if fmt == 3 and comp != 34925 else 2
            cmap = (rng.randint(0, 65536, (1 << bits, 3)).astype(np.uint16)
                    if ph == 3 else None)
            data = W.tiff_bytes(s, ph, bits, order=order, compression=comp,
                                predictor=pred, extra=extra, rows_per_strip=7,
                                sample_format=fmt if fmt != 1 else None,
                                colormap=cmap)
            out.append((f"ph{ph}-{bits}x{spp}-x{'.'.join(map(str, extra))}"
                        f"-f{fmt}-{order}-c{comp}-p{pred}", data))
    return out


def _structure_cases():
    rng = np.random.RandomState(1)
    rgb = _samples(rng, 8, 3, 1)
    wide = _samples(rng, 16, 4, 1)
    gray = _samples(rng, 8, 1, 1)
    out = []
    for order in ("II", "MM"):
        for big in (False, True):
            if big and order == "MM":
                continue  # Pillow reads no big-endian BigTIFF (see refusals)
            for comp in (1, 5, 8, 32773, 34925):
                pred = 2 if comp in (5, 8, 34925) else 1
                for planar, tile, arr, bits in (
                        (1, None, rgb, 8), (2, None, rgb, 8),
                        (1, (16, 16), wide, 16), (2, (32, 16), rgb, 8),
                        (1, (32, 16), gray, 8)):
                    out.append((f"{order}-big{int(big)}-c{comp}-pl{planar}-"
                                f"t{tile and tile[0]}-{bits}",
                                W.tiff_bytes(arr, 2 if arr.shape[2] > 1 else 1,
                                             bits, order=order, bigtiff=big,
                                             compression=comp, predictor=pred,
                                             planar=planar, tile=tile,
                                             rows_per_strip=None if tile else 13)))
    for comp in (1, 5, 8, 32773, 34925):
        for name, arr, ph, bits in (("1", _samples(rng, 1, 1, 1), 0, 1),
                                    ("4", _samples(rng, 4, 1, 1), 1, 4),
                                    ("rgb", rgb, 2, 8)):
            out.append((f"fill2-c{comp}-{name}", W.tiff_bytes(
                arr, ph, bits, compression=comp, fill=2, rows_per_strip=5)))
    for pred in (1, 2):
        out.append((f"lzw-old-p{pred}", W.tiff_bytes(
            rgb, 2, 8, compression=5, lzw_old=True, predictor=pred,
            rows_per_strip=11)))
    big = (rng.randint(0, 4, (120, 200, 3)) * 60).astype(np.uint8)
    for old in (False, True):  # tables that fill and clear
        out.append((f"lzw-full-table-old{int(old)}", W.tiff_bytes(
            big, 2, 8, compression=5, lzw_old=old)))
    return out


def _jpeg_split(data: bytes, markers=(0xDB, 0xC4)):
    """A full JPEG as (JPEGTables: SOI, its segments of ``markers`` (DQT
    and DHT), EOI; the abbreviated stream without them)."""
    tables, rest, pos = [b"\xff\xd8"], [b"\xff\xd8"], 2
    while data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos:pos + 2 + n]
        (tables if data[pos + 1] in markers else rest).append(seg)
        pos += 2 + n
    rest.append(data[pos:])
    return b"".join(tables) + b"\xff\xd9", b"".join(rest)


def _jpeg_cases():
    rng = np.random.RandomState(2)
    yy, xx = np.mgrid[0:WH[1], 0:WH[0]]
    rgb = np.stack([(xx * 6) % 256, (yy * 8) % 256, (xx * yy) % 256], -1)
    rgb = np.clip(rgb + rng.randint(-9, 10, rgb.shape), 0, 255).astype(np.uint8)
    out = []
    for mode in ("RGB", "L"):
        b = io.BytesIO()
        Image.fromarray(rgb).convert(mode).save(b, "TIFF", compression="jpeg")
        out.append((f"pillow-jpeg-{mode}", b.getvalue()))
    # one strip whose tables are all in JPEGTables; 16-row strips and
    # 16x16 tiles (each with its own Huffman tables: the writer's are made
    # of the symbols used) whose quantisation tables are only there
    for tile, rows, markers in ((None, None, (0xDB, 0xC4)),
                                (None, 16, (0xDB,)), ((16, 16), None, (0xDB,))):
        step = rows or WH[1]
        boxes = ([(0, y, WH[0], min(step, WH[1] - y))
                  for y in range(0, WH[1], step)] if tile is None else
                 [(x, y, 16, 16) for y in range(0, WH[1], 16)
                  for x in range(0, WH[0], 16)])
        chunks, tables = [], None
        for x, y, w, h in boxes:
            block = np.zeros((h, w, 3), np.float64)
            part = rgb[y:y + h, x:x + w]
            block[:part.shape[0], :part.shape[1]] = part
            frame = W.frame_from_planes(W.rgb_to_ycc(block),
                                        [(2, 2), (1, 1), (1, 1)], 85)
            tables, chunk = _jpeg_split(W.jpeg_bytes(frame), markers)
            chunks.append(chunk)
        out.append((f"ycbcr420-jpegtables-t{tile and tile[0]}-r{rows}",
                    W.tiff_bytes(rgb, 6, 8, compression=7, jpeg_chunks=chunks,
                                 jpeg_tables=tables, tile=tile,
                                 rows_per_strip=rows, tags=[(530, "H", [2, 2])])))
    return out


CASES = _layout_cases() + _structure_cases() + _jpeg_cases()


@pytest.mark.parametrize("name,data", CASES, ids=[c[0] for c in CASES])
def test_tiff_layout_matches_pillow_and_jax_loaders(tmp_path, name, data):
    path = str(tmp_path / f"{name}.tif")
    with open(path, "wb") as f:
        f.write(data)
    pil = Image.open(path)
    try:
        pil.load()
    except OSError:  # libtiff refuses YCbCr of one sample: so does the port
        with pytest.raises(ValueError, match=rf"{name}\.tif: unsupported"):
            port_image.read_picture(path)
        return
    want = np.asarray(pil)
    if pil.mode == "1":
        want = want.astype(np.uint8) * 255
    if pil.mode == "I;16B":  # the port keeps the values in native order
        want = want.astype(np.uint16)
    pic = port_image.read_picture(path)
    assert pic.mode == pil.mode
    assert pic.pixels.dtype == want.dtype and pic.pixels.shape == want.shape
    np.testing.assert_array_equal(pic.pixels, want)
    if pic.mode in ("P", "PA"):
        pal = np.array(pil.getpalette(), np.uint8).reshape(-1, 3)
        np.testing.assert_array_equal(pic.palette, pal[:len(pic.palette)])
    # other sizes have no half of the same aspect ratio
    if pil.size == WH:
        hold_loaders(path)


def test_tiff_refusals_name_the_file(tmp_path):
    """What the port does not read raises, naming the file: LAB to L (a
    conversion Pillow does not have), separate planes of 16-bit samples
    (Pillow unpacks them as 8-bit bands), a big-endian BigTIFF (Pillow takes
    its header for a classic one and fails, and so does the port), and the
    compressions this Pillow's libtiff lacks too (ThunderScan, old-style
    JPEG, SGILog, SGILog24, WebP), each named.  (CCITT and zstd, refused
    here before, are held in ``test_torch_port_images_tiff_codecs.py``.)"""
    rng = np.random.RandomState(3)
    lab = tmp_path / "lab.tif"
    lab.write_bytes(W.tiff_bytes(_samples(rng, 8, 3, 1), 8, 8))
    with pytest.raises(ValueError, match=r"lab\.tif: conversion from LAB"):
        port_image.convert(port_image.read_picture(str(lab)), "L")
    with pytest.raises(ValueError, match="conversion from LAB to RGB"):
        Image.open(lab).convert("L")
    files = {
        "planes16": W.tiff_bytes(_samples(rng, 16, 3, 1), 2, 16, planar=2),
        "bigtiff-mm": W.tiff_bytes(_samples(rng, 8, 3, 1), 2, 8, order="MM",
                                   bigtiff=True),
        "thunderscan": W.tiff_bytes(_samples(rng, 8, 1, 1), 1, 8,
                                    tags=[(259, "H", [32809])]),
    }
    named = {"thunderscan": "ThunderScan", "old-jpeg": "old-style JPEG",
             "sgilog": "SGILog", "sgilog24": "SGILog24", "webp": "WebP"}
    for name, comp in (("old-jpeg", 6), ("sgilog", 34676), ("sgilog24", 34677),
                       ("webp", 50001)):
        files[name] = W.tiff_bytes(_samples(rng, 8, 1, 1), 1, 8,
                                   tags=[(259, "H", [comp])])
    for name, body in files.items():
        path = tmp_path / f"{name}.tif"
        path.write_bytes(body)
        with pytest.raises(ValueError, match=rf"{name}\.tif: .*"
                           + named.get(name, "")):
            port_image.read_picture(str(path))
        if name != "planes16":  # Pillow reads those, as 8-bit bands
            with pytest.raises(Exception):
                Image.open(path).load()


def test_tiff_lzw_and_packbits_stages_alone():
    """The C++ stages on streams of the writer: LZW new and old style and
    PackBits give back the bytes, an LZW stream cut short gives the bytes
    it holds (and the reader raises, as libtiff's LZWDecode fails short of
    the strip's size), and a code past the table raises."""
    rng = np.random.RandomState(4)
    data = bytes(rng.randint(0, 3, 20000).astype(np.uint8) * 80)
    for old in (False, True):
        enc = W.lzw_tiff(data, old)
        assert tiff._inflate(enc, 5, len(data)) == data
        half = enc[:len(enc) // 2]
        cut = np.zeros(len(data), np.uint8)
        err = ctypes.create_string_buffer(256)
        n = tiff._native().tiff_lzw(half, len(half), cut.ctypes.data,
                                    len(data), err, len(err))
        assert 1000 < n < len(data)
        assert cut[:n].tobytes() == data[:n] and not cut[n:].any()
        with pytest.raises(ValueError, match="LZW: not enough data"):
            tiff._inflate(half, 5, len(data))
    assert tiff._inflate(W.packbits(data), 32773, len(data)) == data
    with pytest.raises(ValueError, match="LZW"):
        tiff._inflate(b"\x80\x1f\xff\xff\xff", 5, 100)
