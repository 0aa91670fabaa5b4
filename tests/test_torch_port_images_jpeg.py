"""The port's JPEG reader (``data/jpeg.py`` with its C++ stages,
``csrc/jpeg_entropy.cpp``) on every JPEG layout Pillow decodes, bit for bit
through the JAX loader functions: progressive Huffman (Pillow's own files at
several qualities and samplings, optimised or not, and the test writer's
scripts), arithmetic coding (sequential and progressive, with DAC
conditioning and restart intervals), lossless (predictors 1-7, the point
transform), CMYK, YCCK and RGB-coded frames, and the samplings libjpeg-turbo
takes beyond 4:4:4 / 4:2:2 / 4:2:0.  Each writer file is first read back by
Pillow.  Also: the C++ entropy stage's coefficients against the plain
Python loop on baseline files, the whole C++ decode against the plain
stages, progressive and arithmetic files against baseline files of the same
coefficients, and a failed build that raises.
"""
import io

import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu_torch.data import jpeg, native

import image_writers as W
from test_torch_port_images import WH, hold_loaders


def _picture(w, h, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([128 + 100 * np.sin(xx / 7), 128 + 100 * np.cos(yy / 5),
                     128 + 60 * np.sin((xx + yy) / 11)], -1)
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255)


def _check(tmp_path, name, data, mode=None):
    """Pillow reads the file; the port's decode equals it (and on a baseline
    file the C++ entropy stage the plain loop); every loader function of
    both packages agrees on it."""
    want = Image.open(io.BytesIO(data))
    if mode:
        assert want.mode == mode
    got, got_mode = jpeg.decode(data)
    assert got_mode == want.mode
    np.testing.assert_array_equal(got, np.asarray(want))
    frame = jpeg._decode(data)[0]
    if not (frame.progressive or frame.arith or frame.lossless):
        # a baseline file: the C++ entropy stage against the plain loop
        for a, b in zip(frame.coef, jpeg._decode(data, plain=True)[0].coef):
            np.testing.assert_array_equal(a, b)
    if want.size == WH:
        path = str(tmp_path / f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        hold_loaders(path)


def _pillow(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, "JPEG", **kw)
    return buf.getvalue()


PILLOW_PROGRESSIVE = [(q, s, o) for q in (50, 90) for s in (0, 1, 2)
                      for o in (False, True)]


@pytest.mark.parametrize("quality,subsampling,optimize", PILLOW_PROGRESSIVE,
                         ids=[f"q{q}-{['444', '422', '420'][s]}-"
                              f"{'opt' if o else 'std'}"
                              for q, s, o in PILLOW_PROGRESSIVE])
def test_pillow_progressive_matches_jax_loaders(tmp_path, quality, subsampling,
                                                optimize):
    data = _pillow(_picture(*WH, seed=quality + subsampling), quality=quality,
                   subsampling=subsampling, optimize=optimize, progressive=True)
    assert Image.open(io.BytesIO(data)).info.get("progressive")
    _check(tmp_path, "p", data, "RGB")


@pytest.mark.parametrize("kw", [dict(quality=80), dict(quality=95,
                                                       restart_marker_rows=1)],
                         ids=["plain", "rst"])
def test_pillow_progressive_gray_and_odd_size(tmp_path, kw):
    _check(tmp_path, "g", _pillow(_picture(*WH, seed=3)[..., 1],
                                  progressive=True, **kw), "L")
    _check(tmp_path, "odd", _pillow(_picture(61, 45, seed=4), progressive=True,
                                    **kw), "RGB")


def test_large_progressive_file():
    data = _pillow(_picture(256, 192, seed=6), quality=92, progressive=True,
                   subsampling=2)
    got, _ = jpeg.decode(data)
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data))))


SAMPLINGS = {
    "444": [(1, 1)] * 3, "440": [(1, 2), (1, 1), (1, 1)],
    "411": [(4, 1), (1, 1), (1, 1)], "410": [(4, 2), (1, 1), (1, 1)],
    "mixed": [(2, 2), (1, 2), (2, 1)], "luma-below": [(1, 1), (2, 2), (2, 2)],
    "h3": [(3, 1), (1, 1), (1, 1)], "h2v2-h2v1": [(2, 2), (2, 1), (1, 1)],
}


def _frame(kind, seed=0, quality=85, size=WH):
    pic = _picture(*size, seed=seed)
    if kind == "gray":
        return W.frame_from_planes([pic[..., 0]], [(1, 1)], quality)
    return W.frame_from_planes(W.rgb_to_ycc(pic), SAMPLINGS[kind], quality)


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_writer_samplings_sequential_and_progressive(tmp_path, sampling):
    f = _frame(sampling, seed=7)
    base = W.jpeg_bytes(f)
    _check(tmp_path, "base", base, "RGB")
    _check(tmp_path, "prog", W.jpeg_bytes(f, progressive=True, restart=5),
           "RGB")


CODINGS = [
    ("prog-spectral", dict(progressive=True, script="spectral")),
    ("prog-simple-rst", dict(progressive=True, restart=3)),
    ("arith", dict(coding="arith")),
    ("arith-rst", dict(coding="arith", restart=4)),
    ("arith-dac", dict(coding="arith", dac=dict(dc_l=[1, 2, 0, 0],
                                                dc_u=[3, 5, 1, 1],
                                                ac_k=[12, 30, 5, 5]))),
    ("arith-prog", dict(coding="arith", progressive=True)),
    ("arith-prog-rst-dac", dict(coding="arith", progressive=True, restart=7,
                                dac=dict(dc_l=[0, 1, 0, 0], dc_u=[2, 2, 1, 1],
                                         ac_k=[3, 40, 5, 5]))),
]


@pytest.mark.parametrize("kind", ["420", "gray"])
@pytest.mark.parametrize("name,kw", CODINGS, ids=[n for n, _ in CODINGS])
def test_writer_codings_match_and_keep_the_coefficients(tmp_path, name, kw,
                                                        kind):
    """Progressive and arithmetic files of one frame's coefficients decode
    to those coefficients exactly (and so to the baseline file's pixels)."""
    f = _frame(kind if kind == "gray" else "mixed", seed=8, quality=75)
    kw = dict(kw)
    if kw.get("script") == "spectral":
        kw["script"] = W.progression(len(f.coef), "spectral")
    data = W.jpeg_bytes(f, **kw)
    _check(tmp_path, name, data, "L" if kind == "gray" else "RGB")
    base = W.jpeg_bytes(f)
    for a, b in zip(jpeg.coefficients(data), jpeg.coefficients(base)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jpeg.decode(data)[0], jpeg.decode(base)[0])


COLOUR = [
    ("rgb-adobe0", 3, dict(jfif=False, adobe=0), None),
    ("rgb-ids", 3, dict(jfif=False), [82, 71, 66]),
    ("ycc-adobe1", 3, dict(jfif=False, adobe=1), None),
    ("cmyk", 4, dict(jfif=False), None),
    ("cmyk-adobe0", 4, dict(jfif=False, adobe=0), None),
    ("ycck-adobe2", 4, dict(jfif=False, adobe=2), None),
    ("ycck-prog", 4, dict(jfif=False, adobe=2, progressive=True), None),
    ("ycck-arith", 4, dict(jfif=False, adobe=2, coding="arith"), None),
]


@pytest.mark.parametrize("name,n,kw,ids", COLOUR, ids=[c[0] for c in COLOUR])
def test_writer_colour_spaces(tmp_path, name, n, kw, ids):
    pic = _picture(*WH, seed=9)
    planes = [pic[..., i] for i in range(3)]
    if n == 4:
        planes = [255 - p for p in planes] + [pic.mean(-1)]
    sampling = [(2, 2)] + [(1, 1)] * (n - 2) + ([(2, 2)] if n == 4 else [(1, 1)])
    f = W.frame_from_planes(planes, sampling[:n], 85, ids=ids)
    _check(tmp_path, name, W.jpeg_bytes(f, **kw), "RGB" if n == 3 else "CMYK")


@pytest.mark.parametrize("predictor", range(1, 8))
def test_writer_lossless(tmp_path, predictor):
    pic = _picture(*WH, seed=10).astype(np.uint8)
    _check(tmp_path, f"ll{predictor}", W.lossless_bytes(
        [pic[..., 0]], predictor=predictor, pt=predictor % 3,
        restart_rows=predictor % 2 * 4), "L")
    if predictor in (1, 4, 7):  # three components: RGB (libjpeg-turbo's guess)
        _check(tmp_path, f"llc{predictor}", W.lossless_bytes(
            [pic[..., i] for i in range(3)], predictor=predictor,
            restart_rows=3), "RGB")


BASELINE = [
    dict(quality=90, subsampling=2, restart_marker_blocks=3),
    dict(quality=80, subsampling=1, restart_marker_rows=1),
    dict(quality=70, subsampling=0, optimize=True),
    dict(quality=100, subsampling=2, optimize=True, restart_marker_rows=2),
    dict(quality=50, subsampling=2),
]


@pytest.mark.parametrize("kw", BASELINE, ids=[str(i) for i in range(len(BASELINE))])
def test_native_stages_equal_the_plain_versions(kw):
    """On baseline files (restart intervals, optimised tables, quality 100):
    the C++ entropy stage's coefficients equal the Python loop's, and the
    whole C++ decode (IDCT, colour) equals the plain numpy stages'."""
    for img in (_picture(61, 45, seed=11), _picture(61, 45, seed=12)[..., 0]):
        data = _pillow(img, **kw)
        for a, b in zip(jpeg.coefficients(data),
                        jpeg.coefficients(data, plain=True)):
            assert a.dtype == b.dtype == np.int16
            np.testing.assert_array_equal(a, b)
        got, mode = jpeg.decode(data)
        plain, plain_mode = jpeg.decode(data, plain=True)
        assert mode == plain_mode
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data))))
    # the writer's odd samplings and four components, through both
    for f in (_frame("440", 13), _frame("h2v2-h2v1", 14)):
        data = W.jpeg_bytes(f, restart=2)
        for a, b in zip(jpeg.coefficients(data),
                        jpeg.coefficients(data, plain=True)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jpeg.decode(data)[0],
                                      jpeg.decode(data, plain=True)[0])


def test_a_failed_build_raises_naming_the_source(tmp_path, monkeypatch):
    bad = tmp_path / "jpeg_entropy.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"building .*jpeg_entropy\.cpp "
                                           r"failed"):
        native.build(bad)
    monkeypatch.setattr(jpeg, "SOURCE", bad)
    monkeypatch.setattr(jpeg, "_lib", None)
    with pytest.raises(RuntimeError, match=r"jpeg_entropy\.cpp failed"):
        jpeg.decode(_pillow(_picture(16, 16)))


LOSSLESS_SAMPLINGS = {"420": [(2, 2), (1, 1), (1, 1)],
                      "440": [(1, 2), (1, 1), (1, 1)],
                      "chroma-above": [(1, 1), (2, 2), (1, 1)]}


@pytest.mark.parametrize("name", sorted(LOSSLESS_SAMPLINGS))
def test_writer_lossless_subsampled(tmp_path, name):
    """Subsampled lossless frames: libjpeg-turbo upsamples them by
    replication (no fancy upsampling with 1x1 data units)."""
    pic = _picture(*WH, seed=15).astype(np.uint8)
    _check(tmp_path, name, W.lossless_bytes(
        [pic[..., i] for i in range(3)], predictor=6, restart_rows=2,
        sampling=LOSSLESS_SAMPLINGS[name], ids=[82, 71, 66]), "RGB")


def test_mcu_limit_and_fractional_sampling(tmp_path):
    """An interleaved scan of more than 10 blocks an MCU and a fractional
    sampling ratio: Pillow raises, so does the port; the same 4x4 luma in
    one-component scans only is read by both."""
    ycc = W.rgb_to_ycc(_picture(*WH, seed=16))
    big = W.frame_from_planes(ycc, [(4, 4), (1, 1), (1, 1)], 80)
    for name, data, match in (
            ("mcu", W.jpeg_bytes(big), "an MCU of more than 10 blocks"),
            ("frac", W.jpeg_bytes(W.frame_from_planes(
                ycc, [(3, 2), (2, 1), (1, 1)], 80)), "a fractional sampling")):
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data)).load()
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=rf"{name}\.jpg: unsupported "
                                             rf"JPEG: {match}"):
            jpeg.read_jpeg(str(path))
    _check(tmp_path, "apart", W.jpeg_bytes(
        big, progressive=True, script=W.progression(3, "spectral")), "RGB")


def test_arithmetic_file_past_pillows_read_block(tmp_path):
    """Pillow feeds libjpeg-turbo 64 KiB blocks, the next one only when
    libjpeg waits for data, and libjpeg-turbo's arithmetic decoder cannot
    wait: Pillow raises "broken data stream" once that decoder reads past
    what has been fed.  The port raises there too, naming the file.  Behind
    70,000 bytes of comments (read, and so fed, ahead of the frame) a scan
    of half the rows lies within Pillow's second block: both read it, to the
    same pixels."""
    import struct

    pic = np.random.RandomState(17).rand(192, 256, 3) * 255

    def arith(rows):
        return W.jpeg_bytes(W.frame_from_planes(
            W.rgb_to_ycc(pic[:rows]), [(1, 1)] * 3, 90), coding="arith",
            restart=4)

    data = arith(192)
    assert len(data) > 65536
    with pytest.raises(OSError, match="broken data stream"):
        Image.open(io.BytesIO(data)).load()
    path = tmp_path / "big.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=r"big\.jpg: unsupported JPEG: an "
                                         r"arithmetic-coded scan read past"):
        jpeg.read_jpeg(str(path))
    com = b"\xff\xfe" + struct.pack(">H", 35002) + b"x" * 35000
    half = arith(96)
    behind = half[:2] + com + com + half[2:]
    assert len(half) < 65536 < 70008 < len(behind) < 131072
    np.testing.assert_array_equal(jpeg.decode(behind)[0],
                                  np.asarray(Image.open(io.BytesIO(behind))))


INCOMPLETE = {
    "luma-ac-6-63-unsent": [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 5, 0, 0),
                            ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)],
    "one-dc-unsent": [((0, 1), 0, 0, 0, 0), ((0,), 1, 2, 0, 0),
                      ((2,), 1, 63, 0, 0), ((1,), 1, 63, 0, 0)],
    "luma-ac-at-al-2": [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 63, 0, 2),
                        ((0,), 1, 63, 2, 1), ((1,), 1, 63, 0, 0),
                        ((2,), 1, 63, 0, 0)],
    "chroma-dc-only": [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 63, 0, 0)],
    "dc-only": [((0, 1, 2), 0, 0, 0, 0)],
    "ac01-unsent": [((0, 1, 2), 0, 0, 0, 0), ((0,), 2, 63, 0, 0),
                    ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)],
}


SMOOTH_FRAMES = [(WH, [(2, 2), (1, 1), (1, 1)]),
                 ((17, 9), [(2, 1), (1, 1), (1, 1)]),
                 ((16, 40), [(1, 2), (1, 1), (1, 1)])]


@pytest.mark.parametrize("size,sampling", SMOOTH_FRAMES,
                         ids=[f"{w}x{h}" for (w, h), _ in SMOOTH_FRAMES])
@pytest.mark.parametrize("name", sorted(INCOMPLETE))
def test_incomplete_progressive_scripts(tmp_path, name, size, sampling):
    """Scripts that leave some of the first 10 coefficients unsent or
    unrefined: libjpeg smooths the blocks (an estimate of each such zero
    coefficient from the DC values of the 5x5 blocks around it, the DC too
    where none of the 10 was sent), and so does the port; where a component
    has no DC scan there is no smoothing.  Narrow and odd sizes put the
    5x5 window at the edges."""
    f = W.frame_from_planes(W.rgb_to_ycc(_picture(*size, seed=18)),
                            sampling, 70)
    _check(tmp_path, name, W.jpeg_bytes(f, progressive=True,
                                        script=INCOMPLETE[name]), "RGB")


def test_arithmetic_tables_past_3(tmp_path):
    """libjpeg keeps 16 arithmetic conditioning tables (Huffman ones: 4); a
    scan naming tables 4-6 (their default conditioning) reads as Pillow
    reads it, and as the same scan on tables 0-2."""
    f = _frame("mixed", seed=19)
    base = W.jpeg_bytes(f, coding="arith")
    data = bytearray(base)
    sos = data.index(b"\xff\xda")
    for j in range(data[sos + 4]):
        t = data[sos + 6 + 2 * j]
        data[sos + 6 + 2 * j] = ((t >> 4) + 4) << 4 | ((t & 15) + 4)
    _check(tmp_path, "t4", bytes(data), "RGB")
    np.testing.assert_array_equal(jpeg.decode(bytes(data))[0],
                                  jpeg.decode(base)[0])
