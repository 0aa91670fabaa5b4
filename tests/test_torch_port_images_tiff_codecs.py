"""The rest of TIFF against Pillow 12.1 (libtiff 4.7) and through the JAX
loader functions, bit for bit: the orientation Pillow applies at the load
(tag 274, else the XMP packet's ``tiff:Orientation``), CCITT fax
(compressions 2, 3 and 4), zstd (50000, predictors 1-3), uncompressed
YCbCr, YCbCr compressed otherwise (libtiff's RGBA interface: every
subsampling, strips and tiles, predictor 2, orientations 1-8) and
libtiff's sampling rule for JPEG-in-TIFF; each C++ stage
(``csrc/ccitt_decode.cpp``, ``csrc/zstd_decode.cpp``) against its plain
Python version; the zstd frames of ``tests/data/zstd`` (every block,
literals and sequence mode, checked by parsing the block headers); and a
PNG whose ``IDAT`` runs past the end of the file.
"""
import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu_torch.data import ccitt, image as port_image, tiff, zstd

import image_writers as W
from test_torch_port_images import WH, hold_loaders
from test_torch_port_images_tiff import _jpeg_split, _samples

H, WW = WH[1], WH[0]
ZSTD_DIR = Path(__file__).resolve().parent / "data" / "zstd"


def _pil_pixels(pil):
    want = np.asarray(pil)
    if pil.mode == "1":
        return want.astype(np.uint8) * 255
    if pil.mode == "I;16B":
        return want.astype(np.uint16)
    return want


def _hold(path, loaders=True):
    """The port's picture equals Pillow's, mode and size too; then every JAX
    loader function agrees with the port's."""
    pil = Image.open(path)
    size = pil.size
    pil.load()
    pic = port_image.read_picture(str(path))
    want = _pil_pixels(pil)
    assert pic.mode == pil.mode
    assert pic.pixels.dtype == want.dtype and pic.pixels.shape == want.shape
    np.testing.assert_array_equal(pic.pixels, want)
    if pic.mode in ("P", "PA"):
        pal = np.array(pil.getpalette(), np.uint8).reshape(-1, 3)
        np.testing.assert_array_equal(pic.palette, pal[:len(pic.palette)])
    if loaders:
        hold_loaders(str(path), native=size)
    return pic


def _bits(rng, h=H, w=WW):
    """Bilevel rows of runs, stripes and noise (0 white, 1 black)."""
    yy, xx = np.mgrid[0:h, 0:w]
    a = ((xx // 5 + yy // 3) % 3 == 0) | (rng.rand(h, w) < 0.1)
    a[:, 7:9] = 1
    a[5:7] = 0
    return a.astype(np.uint8)


# ----------------------------------------------------------- orientation
def _jpeg_tiff(rgb, tile, tags, order="II"):
    """A YCbCr 4:2:0 JPEG-in-TIFF in one strip or 16x16 tiles."""
    h, w = rgb.shape[:2]
    boxes = ([(0, 0, w, h)] if tile is None else
             [(x, y, 16, 16) for y in range(0, h, 16) for x in range(0, w, 16)])
    chunks, tables = [], None
    for x, y, bw, bh in boxes:
        block = np.zeros((bh, bw, 3), np.float64)
        part = rgb[y:y + bh, x:x + bw]
        block[:part.shape[0], :part.shape[1]] = part
        frame = W.frame_from_planes(W.rgb_to_ycc(block), [(2, 2), (1, 1), (1, 1)],
                                    85)
        tables, chunk = _jpeg_split(W.jpeg_bytes(frame), (0xDB,))
        chunks.append(chunk)
    return W.tiff_bytes(rgb, 6, 8, order=order, compression=7,
                        jpeg_chunks=chunks, jpeg_tables=tables, tile=tile,
                        tags=[(530, "H", [2, 2])] + tags)


def _orientation_cases():
    rng = np.random.RandomState(21)
    rgb = _samples(rng, 8, 3, 1).astype(np.uint8)
    out = []
    for o in range(1, 9):
        for comp in (1, 5, 7):
            for tile in (None, (16, 16)):
                for order in ("II", "MM"):
                    tags = [(274, "H", [o])]
                    data = (_jpeg_tiff(rgb, tile, tags, order) if comp == 7 else
                            W.tiff_bytes(rgb, 2, 8, order=order, compression=comp,
                                         tile=tile, rows_per_strip=7,
                                         tags=tags))
                    out.append((f"o{o}-c{comp}-t{tile and tile[0]}-{order}",
                                data))
        # the XMP packet's orientation where tag 274 is absent (both forms)
        xmp = (b'<x:xmpmeta><rdf:Description tiff:Orientation="%d"/>'
               b'</x:xmpmeta>' % o if o % 2 else
               b"<x:xmpmeta><tiff:Orientation>%d</tiff:Orientation>"
               b"</x:xmpmeta>" % o)
        out.append((f"xmp{o}", W.tiff_bytes(rgb, 2, 8, compression=5,
                                             tags=[(700, "B", list(xmp))])))
        # the picture's own mode: 1, P, I;16, RGBA
        out.append((f"o{o}-bilevel-g4", W.tiff_bytes(
            _bits(rng), 0, 1, compression=4, tags=[(274, "H", [o])])))
        cmap = rng.randint(0, 65536, (16, 3)).astype(np.uint16)
        out.append((f"o{o}-palette", W.tiff_bytes(
            _samples(rng, 4, 1, 1), 3, 4, compression=5, colormap=cmap,
            tags=[(274, "H", [o])])))
        out.append((f"o{o}-i16", W.tiff_bytes(
            _samples(rng, 16, 1, 1), 1, 16, tags=[(274, "H", [o])])))
        out.append((f"o{o}-rgba", W.tiff_bytes(
            _samples(rng, 8, 4, 1), 2, 8, extra=(2,), compression=8,
            tags=[(274, "H", [o])])))
    out.append(("xmp-beside-274", W.tiff_bytes(rgb, 2, 8, tags=[
        (274, "H", [1]), (700, "B", list(b'tiff:Orientation="6"'))])))
    out.append(("o9-ignored", W.tiff_bytes(rgb, 2, 8, tags=[(274, "H", [9])])))
    return out


ORIENT = _orientation_cases()


@pytest.mark.parametrize("name,data", ORIENT, ids=[c[0] for c in ORIENT])
def test_orientation_matches_pillow_and_jax_loaders(tmp_path, name, data):
    """Pillow's ``load_end`` transposes by the orientation, in the picture's
    own mode, for every compression, strips and tiles alike; the open size
    is already the transposed one for tag 274 (so the JAX loaders resize
    the transposed picture); an XMP orientation of 5-8 transposes only at
    the load, so a resize to anything but the open size raises in both.
    Where Pillow maps a lone uncompressed tile of a mappable mode (``L``,
    ``P``, ``RGBA``, ``I;16``) it maps it at the swapped open size, so
    orientations 5-8 read the rows at the other width before the
    transpose: the port reads them so too."""
    path = tmp_path / f"{name}.tif"
    path.write_bytes(data)
    pil = Image.open(path)
    opened = pil.size
    pil.load()
    late = pil.size != opened
    pic = _hold(path, loaders=not late)
    assert pic.pixels.shape[1::-1] == pil.size
    if not late:
        return
    # the JAX loaders' aspect check fails where the load changes the size
    # (an XMP orientation of 5-8; Pillow's map of a lone raw tile at the
    # swapped size); the resize they call: a copy of the loaded picture at
    # the open size, else it raises
    for size in (opened, (opened[0] // 2, opened[1] // 2)):
        try:
            want = np.asarray(Image.open(path).resize(size, Image.LANCZOS))
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                port_image.resize(pic, size)
            continue
        np.testing.assert_array_equal(port_image.resize(pic, size).pixels, want)


# ---------------------------------------------------------------- CCITT
def _fax_cases():
    rng = np.random.RandomState(22)
    a = _bits(rng)
    out = []
    for comp in (2, 3, 4):
        for opt in ((0, 1, 4, 5) if comp == 3 else (0,)):
            for ph in (0, 1):
                for fill in (1, 2):
                    for tile, rps in ((None, None), (None, 7), ((16, 16), None)):
                        order = "MM" if (opt + ph + fill) % 2 else "II"
                        tags = ([(293 if comp == 4 else 292, "I", [opt])]
                                if comp != 2 else [])
                        out.append((f"c{comp}-o{opt}-ph{ph}-f{fill}-t"
                                    f"{tile and tile[0]}-r{rps}-{order}",
                                    W.tiff_bytes(a, ph, 1, order=order,
                                                 compression=comp, fill=fill,
                                                 tile=tile, rows_per_strip=rps,
                                                 tags=tags)))
    # Pillow's own (libtiff's encoder): every option it writes
    for comp, info in (("group4", {}), ("group3", {}), ("group3", {292: 1}),
                       ("group3", {292: 5}), ("group3", {292: 2}),
                       ("tiff_ccitt", {}), ("group4", {278: 7})):
        b = io.BytesIO()
        Image.fromarray(a.astype(bool)).save(b, "TIFF", compression=comp,
                                             tiffinfo=info)
        out.append((f"pillow-{comp}-{'-'.join(map(str, info.values()))}",
                    b.getvalue()))
    return out


FAX = _fax_cases()


@pytest.mark.parametrize("name,data", FAX, ids=[c[0] for c in FAX])
def test_ccitt_matches_pillow_and_jax_loaders(tmp_path, name, data):
    path = tmp_path / f"{name}.tif"
    path.write_bytes(data)
    _hold(path)


def _strips(data):
    t = tiff._ifd(data, "II", False)
    return t, [data[o:o + c] for o, c in zip(t[273], t[279])]


def test_ccitt_stage_equals_plain_and_pillow_on_mutations(tmp_path):
    """Seeded byte changes in the strips of one-strip fax files and of a
    T.6 file of 7-row strips: the C++ stage and the plain version give the
    same rows, run buffers and faults; for Modified Huffman, 1-D T.4 and
    T.6 the port reads where Pillow reads, equal on every row libtiff
    writes, and raises where it raises.  (A strip that ends early leaves
    its other rows as Pillow's buffer held them, which is memory Pillow
    never initialised.  Where 2-D T.4 data runs out inside a strip, and
    after a T.4 strip that ends early, libtiff's results are not yet
    modelled: ``ROADMAP.md``, Queue 3.)"""
    rng = np.random.RandomState(23)
    a = _bits(rng)
    files = []
    for comp, opt in ((2, 0), (3, 0), (3, 1), (3, 5), (4, 0)):
        tags = [(293 if comp == 4 else 292, "I", [opt])] if comp != 2 else []
        files.append(W.tiff_bytes(a, 0, 1, compression=comp, tags=tags))
    files.append(W.tiff_bytes(a, 0, 1, compression=4, rows_per_strip=7))
    path = tmp_path / "fax.tif"
    agreed = 0
    for _ in range(160):
        d = bytearray(files[rng.randint(len(files))])
        ifd = struct.unpack_from("<I", d, 4)[0]
        j = rng.randint(8, ifd)
        if rng.randint(2):
            d[j] = rng.randint(256)
        else:
            d[j] ^= 1 << rng.randint(8)
        d = bytes(d)
        t, strips = _strips(d)
        comp, rps = t[259][0], t.get(278, (H,))[0]
        opt = t.get(293 if comp == 4 else 292, (0,))[0]
        runs_c = np.array(ccitt.run_buffer(WW, comp, opt), np.uint32)
        runs_p = ccitt.run_buffer(WW, comp, opt)
        buf_c, buf_p = np.zeros((rps, WW), np.uint8), np.zeros((rps, WW), np.uint8)
        written, failed = [], False
        for k, strip in enumerate(strips):
            rows = min(rps, H - k * rps)
            try:
                n_c = ccitt.decode(strip, comp, opt, WW, rows, runs_c, buf_c)
            except ValueError:
                n_c = -1
            try:
                n_p = ccitt.decode_plain(strip, comp, opt, WW, rows, runs_p, buf_p)
            except ValueError:
                n_p = -1
            assert n_c == n_p
            np.testing.assert_array_equal(buf_c, buf_p)
            assert runs_c.tolist() == runs_p
            if n_c < 0:
                failed = True
                break
            written += list(range(k * rps, k * rps + n_c))
        if comp == 3 and opt & 1:
            continue
        path.write_bytes(d)
        try:
            pil = Image.open(path)
            pil.load()
        except OSError:
            assert failed
            with pytest.raises(ValueError, match=r"fax\.tif: "):
                port_image.read_picture(str(path))
            continue
        assert not failed
        got = port_image.read_picture(str(path)).pixels
        np.testing.assert_array_equal(got[written], _pil_pixels(pil)[written])
        agreed += 1
    assert agreed > 60


# ----------------------------------------------------------------- zstd
def _zstd_cases():
    import zstandard
    rng = np.random.RandomState(24)
    yy, xx = np.mgrid[0:H, 0:WW]
    rgb = np.stack([(xx * 6) % 256, (yy * 8) % 256, (xx * yy) % 256], -1)
    f32 = (xx * 3.5 - yy * 100.25 + rng.randn(H, WW) * 1e3).astype(np.float32)
    u16 = ((xx * 1000 + yy * 77) % 65536).astype(np.uint16)
    out = []
    for i, (order, pred, (tile, rps), (arr, ph, bits)) in enumerate(
            (o, p, tr, ab) for o in ("II", "MM") for p in (1, 2, 3)
            for tr in ((None, None), (None, 7), ((16, 16), None))
            for ab in ((rgb, 2, 8), (u16, 1, 16), (f32, 1, 32))):
        if pred == 3 and bits != 32:
            continue  # libtiff takes the float predictor on floats only
        level, checksum = (1, 19)[i % 2], bool(i % 3)
        codec = (lambda b, level=level, checksum=checksum: zstandard.ZstdCompressor(
            level=level, write_checksum=checksum).compress(b))
        out.append((f"{order}-p{pred}-t{tile and tile[0]}-r{rps}-{bits}",
                    W.tiff_bytes(arr, ph, bits, order=order, compression=50000,
                                 predictor=pred, tile=tile, rows_per_strip=rps,
                                 zstd_codec=codec,
                                 sample_format=3 if bits == 32 else None)))
    for pred in (1, 2):
        b = io.BytesIO()
        Image.fromarray(rgb.astype(np.uint8)).save(
            b, "TIFF", compression="zstd",
            tiffinfo={317: pred} if pred > 1 else {})
        out.append((f"pillow-p{pred}", b.getvalue()))
    return out


ZSTD = _zstd_cases()


@pytest.mark.parametrize("name,data", ZSTD, ids=[c[0] for c in ZSTD])
def test_zstd_matches_pillow_and_jax_loaders(tmp_path, name, data):
    path = tmp_path / f"{name}.tif"
    path.write_bytes(data)
    pil = Image.open(path)
    pil.load()
    pic = port_image.read_picture(str(path))
    assert pic.mode == pil.mode
    np.testing.assert_array_equal(pic.pixels, _pil_pixels(pil))
    if pic.mode != "F":
        hold_loaders(str(path))


def test_zstd_predictor_3_on_integers_raises_as_pillow(tmp_path):
    path = tmp_path / "p3-int.tif"
    path.write_bytes(W.tiff_bytes(_samples(np.random.RandomState(0), 16, 1, 1),
                                  1, 16, compression=50000, predictor=3))
    with pytest.raises(OSError):
        Image.open(path).load()
    with pytest.raises(ValueError, match=r"p3-int\.tif: .*predictor 3"):
        port_image.read_picture(str(path))


def _fixtures():
    digests = json.loads((ZSTD_DIR / "digests.json").read_text())
    return [(name, (ZSTD_DIR / f"{name}.zst").read_bytes(), meta)
            for name, meta in sorted(digests.items())]


def test_zstd_fixtures_cover_every_mode_and_both_stages_agree():
    """The committed frames decode, in the C++ stage and the plain version,
    to the content ``zstandard`` wrote (length and SHA-256); together their
    block headers take every block, literals, Huffman-weight and sequence
    table mode."""
    seen = set()
    for name, frame, meta in _fixtures():
        a = zstd.decompress_plain(frame, meta["size"])
        b = zstd.decompress(frame, meta["size"])
        assert a == b, name
        assert len(a) == meta["size"] and hashlib.sha256(a).hexdigest() == \
            meta["sha256"], name
        for block in zstd.blocks(frame):
            seen |= {(k, str(v)) for k, v in block.items() if k != "sequences"}
    want = {("type", t) for t in ("raw", "rle", "compressed")}
    want |= {("literals", t) for t in ("raw", "rle", "compressed", "treeless")}
    want |= {("streams", "1"), ("streams", "4"), ("weights", "direct"),
             ("weights", "fse")}
    want |= {(k, m) for k in ("ll", "of", "ml")
             for m in ("predefined", "rle", "fse", "repeat")}
    assert want <= seen, want - seen


def test_zstd_stage_equals_plain_on_corrupt_frames():
    """Seeded byte changes, bit flips and cuts of the fixtures: both stages
    give the same bytes or both raise; a changed content checksum raises; a
    frame that asks for a dictionary raises; libtiff's "Not enough data"
    where the frame is short."""
    rng = np.random.RandomState(25)
    # the small frames: the plain version decodes a byte a Python step
    fixtures = [f for f in _fixtures() if f[2]["size"] < 50_000]
    raised = 0
    for _ in range(300):
        name, frame, meta = fixtures[rng.randint(len(fixtures))]
        d = bytearray(frame)
        kind = rng.randint(3)
        if kind == 0:
            d[rng.randint(len(d))] = rng.randint(256)
        elif kind == 1:
            d[rng.randint(len(d))] ^= 1 << rng.randint(8)
        else:
            d = d[:rng.randint(len(d))]
        outs = []
        for fn in (zstd.decompress_plain, zstd.decompress):
            try:
                outs.append(fn(bytes(d), meta["size"]))
            except ValueError:
                outs.append(None)
        assert outs[0] == outs[1], name
        raised += outs[0] is None
    assert raised > 50
    name, frame, meta = [f for f in fixtures if f[0] == "aab_predefined"][0]
    bad = bytearray(frame)
    bad[-1] ^= 1  # the checksum's last byte
    for fn in (zstd.decompress_plain, zstd.decompress):
        with pytest.raises(ValueError, match="checksum"):
            fn(bytes(bad), meta["size"])
        with pytest.raises(ValueError, match="Not enough data"):
            fn(frame, meta["size"] + 1)
    with_dict = bytearray(frame)
    with_dict[4] |= 1  # a one-byte dictionary ID follows the descriptor
    with_dict[5:5] = b"\x07"
    for fn in (zstd.decompress_plain, zstd.decompress):
        with pytest.raises(ValueError, match="dictionary"):
            fn(bytes(with_dict), meta["size"])
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999


# ------------------------------------------------- the refused layouts
def test_uncompressed_ycbcr_reads_as_pillows_raw_decoder(tmp_path):
    """Pillow reads uncompressed YCbCr with its own raw decoder as ``RGBX``
    rows (four bytes a pixel, the subsampling ignored), from each strip's or
    tile's offset on past its bytes; where the file ends first both raise
    "image file is truncated"."""
    rng = np.random.RandomState(26)
    ycc = rng.randint(0, 256, (H, WW, 3)).astype(np.uint8)
    read = raised = 0
    for sub in ((1, 1), (2, 2), (2, 1)):
        for tile, rps in ((None, None), (None, 7), ((16, 16), None),
                          ((40, 30), None), ((13, 13), None)):
            for extra in (0, 50, 5000):
                data = W.tiff_bytes(ycc, 6, 8, tile=tile, rows_per_strip=rps,
                                    tags=[(530, "H", list(sub))])
                path = tmp_path / "ycc.tif"
                path.write_bytes(data + bytes(rng.randint(0, 256, extra).astype(
                    np.uint8)))
                try:
                    pil = Image.open(path)
                    pil.load()
                except OSError:
                    with pytest.raises(ValueError, match=r"ycc\.tif: "):
                        port_image.read_picture(str(path))
                    raised += 1
                    continue
                pic = port_image.read_picture(str(path))
                assert pic.mode == pil.mode == "RGB"
                np.testing.assert_array_equal(pic.pixels, np.asarray(pil))
                read += 1
    assert read > 20 and raised > 5


@pytest.mark.parametrize("photo", [2, 6])
def test_jpeg_in_tiff_sampling_as_libtiff(tmp_path, photo):
    """``JPEGPreDecode``: the first component's sampling factors must be the
    YCbCrSubsampling tag's (2x2 where absent; 1x1 for RGB) and the others'
    1x1, else libtiff (and so Pillow) fails: subsampled RGB JPEG-in-TIFF
    raises; YCbCr reads where the tag matches."""
    rng = np.random.RandomState(27)
    yy, xx = np.mgrid[0:H, 0:WW]
    rgb = np.clip(np.stack([(xx * 6) % 256, (yy * 8) % 256, (xx * yy) % 256], -1)
                  + rng.randint(-9, 10, (H, WW, 3)), 0, 255).astype(np.uint8)
    outcomes = set()
    for samp in ([(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)],
                 [(1, 1), (2, 2), (1, 1)]):
        for tag in (None, (1, 1), (2, 2), (2, 1)):
            planes = (W.rgb_to_ycc(rgb.astype(np.float64)) if photo == 6 else
                      [rgb[..., i].astype(np.float64) for i in range(3)])
            frame = W.frame_from_planes(planes, samp, 85)
            tables, chunk = _jpeg_split(W.jpeg_bytes(frame, jfif=photo == 6),
                                        (0xDB,))
            path = tmp_path / "sampling.tif"
            path.write_bytes(W.tiff_bytes(
                rgb, photo, 8, compression=7, jpeg_chunks=[chunk],
                jpeg_tables=tables,
                tags=[(530, "H", list(tag))] if tag else []))
            try:
                pil = Image.open(path)
                pil.load()
            except OSError:
                with pytest.raises(ValueError, match=r"sampling\.tif: .*sampling"):
                    port_image.read_picture(str(path))
                outcomes.add("raises")
                continue
            np.testing.assert_array_equal(port_image.read_picture(str(path)).pixels,
                                          np.asarray(pil))
            outcomes.add("reads")
    assert outcomes == {"raises", "reads"}


def test_cut_jpeg_in_tiff_strip_reads_as_libtiff(tmp_path):
    """libtiff hands libjpeg a fake EOI where a strip's bytes run out, so a
    JPEG strip cut short decodes (its rest grey) where Pillow's own JPEG
    reader would wait for more: the port reads it as Pillow does."""
    rng = np.random.RandomState(29)
    yy, xx = np.mgrid[0:H, 0:WW]
    rgb = np.clip(np.stack([(xx * 6) % 256, (yy * 8) % 256, (xx * yy) % 256], -1)
                  + rng.randint(-9, 10, (H, WW, 3)), 0, 255).astype(np.uint8)
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, "TIFF", compression="jpeg")
    data = bytearray(b.getvalue())
    t = tiff._ifd(bytes(data), "II", False)
    ifd = struct.unpack_from("<I", data, 4)[0]
    at = [ifd + 2 + 12 * i + 8 for i in range(struct.unpack_from("<H", data, ifd)[0])
          if struct.unpack_from("<H", data, ifd + 2 + 12 * i)[0] == 279][0]
    path = tmp_path / "cut.tif"
    for cut in range(t[279][0] - 60, t[279][0], 7):
        struct.pack_into("<I", data, at, cut)
        path.write_bytes(bytes(data))
        pil = Image.open(path)
        pil.load()
        np.testing.assert_array_equal(port_image.read_picture(str(path)).pixels,
                                      np.asarray(pil))


def test_zstd_mutations_agree_with_pillow(tmp_path):
    """Seeded changes of one byte in the strips of zstd TIFFs (noisy RGB
    and a few-symbol text image, one strip and strips of 20 rows, levels
    1, 3 and 19: literals in one and in four Huffman streams): the port
    reads what Pillow's libzstd reads, as it reads it, and raises where it
    raises.  libzstd reads four streams of 8 bytes or more with its fast
    decoders, which read a stream on past its start and do not check where
    it ends; shorter ones with the decoder ``HUF_selectDecoder`` picks (X2
    skips a last pair's bits); one stream with X1, which must end on the
    stream's first bit."""
    import zstandard
    rng = np.random.RandomState(31)
    h, w = 60, 80
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.clip(np.stack([(xx * 6) % 256, (yy * 8) % 256, (xx * yy) % 256],
                           -1) + rng.randint(-20, 21, (h, w, 3)), 0,
                  255).astype(np.uint8)
    text = rng.choice(np.frombuffer(b"etaoin shrdlu cmfwyp", np.uint8),
                      (h, w, 3)).astype(np.uint8)
    files = [W.tiff_bytes(arr, 2, 8, compression=50000, rows_per_strip=rps,
                          zstd_codec=zstandard.ZstdCompressor(
                              level=level).compress)
             for arr in (rgb, text) for rps in (None, 20)
             for level in (1, 3, 19)]
    path = tmp_path / "mutated.tif"
    seen = {"agreed": 0, "raised": 0}
    for _ in range(400):
        d = bytearray(files[rng.randint(len(files))])
        t = tiff._ifd(bytes(d), "II", False)
        k = rng.randint(len(t[273]))
        j = rng.randint(t[273][k], t[273][k] + t[279][k])
        if rng.randint(2):
            d[j] = rng.randint(256)
        else:
            d[j] ^= 1 << rng.randint(8)
        path.write_bytes(bytes(d))
        try:
            pil = Image.open(path)
            pil.load()
        except Exception:
            with pytest.raises(ValueError):
                port_image.read_picture(str(path))
            seen["raised"] += 1
            continue
        pic = port_image.read_picture(str(path))
        np.testing.assert_array_equal(pic.pixels, np.asarray(pil))
        seen["agreed"] += 1
    assert seen["agreed"] > 200 and seen["raised"] > 10, seen


def test_jpeg_in_tiff_mutations_agree_with_pillow(tmp_path):
    """Seeded changes of one byte in the strips of Pillow's JPEG-in-TIFF
    files (RGB in one strip and in strips of 8 rows, gray in strips of 16):
    the port reads what Pillow reads, as Pillow reads it, and raises where
    it raises.  It models libtiff's one decompressor, whose tables stay in
    force from strip to strip, its frame size checks, and its
    ``jpeg_finish_decompress`` faults let be.  A frame smaller than the
    first strip leaves the rest of Pillow's strip buffer as memory Pillow
    never initialised: the port raises there, saying so."""
    rng = np.random.RandomState(30)
    yy, xx = np.mgrid[0:H, 0:WW]
    rgb = np.clip(np.stack([(xx * 6) % 256, (yy * 8) % 256, (xx * yy) % 256],
                           -1) + rng.randint(-9, 10, (H, WW, 3)), 0,
                  255).astype(np.uint8)
    files = []
    for img, info in ((rgb, {}), (rgb, {278: 8}), (rgb[..., 0], {278: 16})):
        b = io.BytesIO()
        Image.fromarray(img).save(b, "TIFF", compression="jpeg",
                                  tiffinfo=info)
        files.append(b.getvalue())
    path = tmp_path / "mutated.tif"
    seen = {"agreed": 0, "raised": 0, "uninitialised": 0}
    for _ in range(400):
        d = bytearray(files[rng.randint(len(files))])
        t = tiff._ifd(bytes(d), "II", False)
        j = rng.randint(min(t[273]), max(o + c for o, c in zip(t[273],
                                                                t[279])))
        if rng.randint(2):
            d[j] = rng.randint(256)
        else:
            d[j] ^= 1 << rng.randint(8)
        path.write_bytes(bytes(d))
        try:
            pil = Image.open(path)
            pil.load()
        except Exception:
            with pytest.raises(ValueError):
                port_image.read_picture(str(path))
            seen["raised"] += 1
            continue
        try:
            pic = port_image.read_picture(str(path))
        except ValueError as e:
            assert "never initialised" in str(e), e
            seen["uninitialised"] += 1
            continue
        np.testing.assert_array_equal(pic.pixels, np.asarray(pil))
        seen["agreed"] += 1
    assert seen["agreed"] > 300 and seen["raised"] > 5, seen


# ------------------------------------------------------------------ PNG
# ---------------------------------- YCbCr through libtiff's RGBA interface
_SUBSAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
_RGBA_COMPRESSIONS = (5, 8, 32946, 32773, 34925, 50000)


def _ycbcr_cases():
    """YCbCr compressed other than as JPEG: each subsampling in strips of 8
    rows and in 16x16 tiles (edge tiles cut on both sides), the
    compressions in turn, predictor 2 (where libtiff's rows do not divide
    its predictor refuses them, and the bytes go on undone), big- and
    little-endian; orientations 1-8 (tag 274) and an XMP one; separate
    planes at 1x1; an odd size at 2x2 and 4x4."""
    rng = np.random.RandomState(24)
    ycc = _samples(rng, 8, 3, 1).astype(np.uint8)
    out = []
    k = 0
    for ss in _SUBSAMPLINGS:
        for tile, rps in ((None, 8), ((16, 16), None)):
            for pred in (1, 2):
                comp = _RGBA_COMPRESSIONS[k % len(_RGBA_COMPRESSIONS)]
                k += 1
                order = "MM" if k % 3 == 0 else "II"
                out.append((f"ss{ss[0]}{ss[1]}-c{comp}-t{tile and tile[0]}"
                            f"-p{pred}-{order}", W.tiff_bytes(
                                ycc, 6, 8, order=order, compression=comp,
                                predictor=pred if comp not in (32773,)
                                else 1, tile=tile, rows_per_strip=rps,
                                subsampling=ss)))
    for o in range(1, 9):
        for tile in (None, (16, 16)):
            out.append((f"ss22-o{o}-t{tile and tile[0]}", W.tiff_bytes(
                ycc, 6, 8, compression=5, tile=tile, rows_per_strip=7,
                subsampling=(2, 2), tags=[(274, "H", [o])])))
    out.append(("ss22-xmp6", W.tiff_bytes(ycc, 6, 8, compression=8,
                                          subsampling=(2, 2), tags=[
        (700, "B", list(b'<x tiff:Orientation="6"/>'))])))
    out.append(("ss11-planes", W.tiff_bytes(ycc, 6, 8, compression=5,
                                            planar=2, tags=[
        (530, "H", [1, 1])])))
    out.append(("ss-default", W.tiff_bytes(ycc, 6, 8, compression=50000,
                                           subsampling=(2, 2), tags=[
        (530, "H", [2, 2])])))
    odd = _samples(rng, 8, 3, 1).astype(np.uint8)[:27, :37]
    for ss in ((2, 2), (4, 4)):
        for tile in (None, (16, 16)):
            out.append((f"odd-ss{ss[0]}{ss[1]}-t{tile and tile[0]}",
                        W.tiff_bytes(odd, 6, 8, compression=5, tile=tile,
                                     subsampling=ss)))
    return out


YCBCR = _ycbcr_cases()


@pytest.mark.parametrize("name,data", YCBCR, ids=[c[0] for c in YCBCR])
def test_ycbcr_rgba_path_matches_pillow_and_jax_loaders(tmp_path, name, data):
    """YCbCr compressed with LZW, Deflate, PackBits, LZMA and zstd, read as
    Pillow's libtiff decoder reads it (``TIFFRGBAImageGet``): the picture,
    then every JAX loader function where the open size is the loaded one."""
    path = tmp_path / f"{name}.tif"
    path.write_bytes(data)
    pil = Image.open(path)
    opened = pil.size
    pil.load()
    _hold(path, loaders=pil.size == opened and pil.size == WH)


def test_ycbcr_coefficients_and_reference_as_libtiff(tmp_path):
    """``YCbCrCoefficients`` and ``ReferenceBlackWhite`` (RATIONAL, read
    into floats as libtiff reads them) set the tables; values libtiff
    refuses, and layouts its RGBA interface has no routine for (separate
    planes past 1x1, a subsampling of 2x4, 1x4 or 3x3), raise as Pillow
    raises, naming the file."""
    rng = np.random.RandomState(25)
    ycc = _samples(rng, 8, 3, 1).astype(np.uint8)
    reads = {
        "rec709": [(529, "R", [2126, 10000, 7152, 10000, 722, 10000])],
        "thirds": [(529, "R", [1, 3, 1, 3, 1, 3])],
        "studio": [(532, "R", [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240,
                               1])],
        "halves": [(532, "R", [15, 2, 471, 2, 256, 2, 481, 2, 255, 2, 479,
                               2])],
    }
    for name, tags in reads.items():
        path = tmp_path / f"{name}.tif"
        path.write_bytes(W.tiff_bytes(ycc, 6, 8, compression=8,
                                      subsampling=(2, 1), tags=tags))
        _hold(path, loaders=False)
    refused = {
        "zero-green": W.tiff_bytes(ycc, 6, 8, compression=5, subsampling=(
            2, 2), tags=[(529, "R", [1, 3, 0, 1, 1, 3])]),
        "planes22": W.tiff_bytes(ycc, 6, 8, compression=5, planar=2,
                                 tags=[(530, "H", [2, 2])]),
    }
    for ss in ((2, 4), (1, 4), (3, 3)):
        refused[f"ss{ss[0]}{ss[1]}"] = W.tiff_bytes(
            ycc, 6, 8, compression=5, rows_per_strip=8,
            tags=[(530, "H", list(ss))])
    for name, data in refused.items():
        path = tmp_path / f"{name}.tif"
        path.write_bytes(data)
        with pytest.raises(OSError):
            Image.open(path).load()
        with pytest.raises(ValueError, match=rf"{name}\.tif: "):
            port_image.read_picture(str(path))


def test_ycbcr_stage_equals_plain():
    """``tiff_ycbcr`` and ``ycbcr_rgb_plain`` on seeded units: every
    subsampling, partial blocks on the right and bottom, libtiff's skew of
    a cut tile (its 4x4 one included), the default and other tables."""
    rng = np.random.RandomState(26)
    tables = [tiff.ycbcr_tables({}), tiff.ycbcr_tables({
        (529, "pairs"): (2126, 10000, 7152, 10000, 722, 10000),
        (532, "pairs"): (16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1)})]
    for hs, vs in _SUBSAMPLINGS:
        for w, h, tw in ((16, 16, 16), (13, 11, 16), (5, 7, 16), (37, 3, 40)):
            units = rng.randint(0, 256, 4096).astype(np.uint8)
            for tabs in tables:
                got = tiff.ycbcr_rgb(units, w, h, hs, vs, tw - w, tabs)
                want = tiff.ycbcr_rgb_plain(units, w, h, hs, vs, tw - w, tabs)
                np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="run past"):
        tiff.ycbcr_rgb(np.zeros(10, np.uint8), 16, 16, 2, 2, 0, tables[0])
    with pytest.raises(ValueError, match="run past"):
        tiff.ycbcr_rgb_plain(np.zeros(10, np.uint8), 16, 16, 2, 2, 0,
                             tables[0])


def test_lzw_and_ifd_mutations_agree_with_pillow(tmp_path):
    """Seeded changes of one byte in the LZW strips (one strip, and strips
    of 7 rows) and in the IFD entries of LZW and uncompressed TIFFs: the
    port reads what Pillow reads, as Pillow reads it, and raises where it
    raises.  Among them: LZW data whose EOI comes early or whose codes run
    out short of the strip (libtiff's "Not enough data": Pillow's "decoder
    error -2"), codes past the strip's size (libtiff stops there), a tag
    whose data runs past the file (Pillow's IFD ends there, keeping the
    tags before), a strip past the file, a PlanarConfiguration or a type
    libtiff refuses."""
    rng = np.random.RandomState(27)
    rgb = _samples(rng, 8, 3, 1).astype(np.uint8) // 64 * 64
    files = [W.tiff_bytes(rgb, 2, 8, compression=5),
             W.tiff_bytes(rgb, 2, 8, compression=5, rows_per_strip=7,
                          predictor=2),
             W.tiff_bytes(rgb, 2, 8, rows_per_strip=7)]
    path = tmp_path / "mutated.tif"
    seen = {"lzw": 0, "past": 0, "agreed": 0}
    for _ in range(400):
        d = bytearray(files[rng.randint(len(files))])
        t = tiff._ifd(bytes(d), "II", False)
        ifd = struct.unpack_from("<I", d, 4)[0]
        if rng.randint(2):  # a byte of the strips
            j = rng.randint(8, ifd)
        else:  # a byte of an entry's type, count or value
            j = ifd + 2 + 12 * rng.randint(len(t["entries"])) + \
                rng.randint(2, 12)
        d[j] = rng.randint(256)
        path.write_bytes(bytes(d))
        cut = [e for e in tiff._ifd(bytes(d), "II", False)["entries"]]
        try:
            pil = Image.open(path)
            pil.load()
        except Exception as e:
            seen["lzw"] += "decoder error" in str(e) and j < ifd
            with pytest.raises(ValueError):
                port_image.read_picture(str(path))
            continue
        if len(cut) < len(t["entries"]):
            seen["past"] += 1
        pic = port_image.read_picture(str(path))
        assert pic.mode == pil.mode
        np.testing.assert_array_equal(pic.pixels, _pil_pixels(pil))
        seen["agreed"] += 1
    assert seen["lzw"] > 5 and seen["past"] > 0 and seen["agreed"] > 150, seen


def test_png_idat_past_the_file_as_pillow(tmp_path):
    """An IDAT whose length runs past the end of the file gives the bytes
    that are there (``load_read``); the image reads where the zlib stream
    completes it, and also where the stream ends at the end of a row (the
    rows after stay zero, as Pillow's zip decoder leaves them); it raises
    "image file is truncated" where the stream ends mid-row or the data
    ends before the stream."""
    rng = np.random.RandomState(28)
    img = rng.randint(0, 256, (H, WW, 3))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    outcomes = {}
    for interlace in (False, True):
        d = W.png_bytes(img, 8, 2, interlace=interlace)
        at = d.find(b"IDAT") - 4
        head, pos, bodies = d[:at], at, []
        while d[pos + 4:pos + 8] == b"IDAT":
            n = struct.unpack(">I", d[pos:pos + 4])[0]
            bodies.append(d[pos + 8:pos + 8 + n])
            pos += 12 + n
        body = b"".join(bodies)
        raw = zlib.decompress(body)
        flushed = zlib.compressobj()
        flushed = flushed.compress(raw) + flushed.flush(zlib.Z_SYNC_FLUSH)
        row = 1 + WW * 3
        files = {
            "past-end": head + struct.pack(">I", len(body) + 1000) + b"IDAT" + body,
            "cut-mid": head + struct.pack(">I", len(body)) + b"IDAT"
            + body[:len(body) // 2],
            "no-stream-end": head + chunk(b"IDAT", flushed) + chunk(b"IEND", b""),
            "rows-5": head + chunk(b"IDAT", zlib.compress(raw[:5 * row]))
            + chunk(b"IEND", b""),
            "mid-row": head + chunk(b"IDAT", zlib.compress(raw[:5 * row + 3]))
            + chunk(b"IEND", b""),
            "second-idat-cut": head + chunk(b"IDAT", body[:len(body) // 2])
            + struct.pack(">I", len(body)) + b"IDAT" + body[len(body) // 2:],
        }
        for name, data in files.items():
            path = tmp_path / f"{name}-{interlace}.png"
            path.write_bytes(data)
            try:
                pil = Image.open(path)
                pil.load()
            except OSError as e:
                assert "truncated" in str(e)
                with pytest.raises(ValueError, match="truncated"):
                    port_image.read_picture(str(path))
                outcomes[(name, interlace)] = "raises"
                continue
            np.testing.assert_array_equal(port_image.read_picture(str(path)).pixels,
                                          np.asarray(pil))
            outcomes[(name, interlace)] = "reads"
    assert outcomes[("past-end", False)] == outcomes[("rows-5", False)] == "reads"
    assert outcomes[("cut-mid", False)] == outcomes[("mid-row", False)] == "raises"
