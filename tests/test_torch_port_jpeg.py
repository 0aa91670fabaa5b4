"""The port's image readers against Pillow on the CPU: the baseline JPEG
decoder (``data/jpeg.py``) bit for bit against ``Image.open(p).convert("RGB")``
at several sizes (odd ones too), qualities, subsamplings, restart intervals,
optimised Huffman tables and grayscale, and its refusals; the PNG reader's
wavefront unfiltering (``data/png.py``) bit for bit on rows of mixed filter
types and on Pillow's own adaptive filtering.  Every hold is bit-equality.
"""
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu_torch.data import jpeg, png
from nerf_pl_tpu_torch.data.llff import read_image


def _picture(w, h, seed=0):
    """Smooth colour ramps with noise: every DCT band and every chroma
    upsampling edge case gets non-zero data."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(xx / 7), 128 + 100 * np.cos(yy / 5),
                     128 + 60 * np.sin((xx + yy) / 11)], -1)
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(
        np.uint8)


def _jpeg(tmp_path, img, name="t.jpg", **kw):
    path = tmp_path / name
    Image.fromarray(img).save(path, "JPEG", **kw)
    return str(path)


def _check(path):
    want = np.asarray(Image.open(path).convert("RGB"))
    got = read_image(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("size", [(61, 45), (64, 48), (17, 9), (100, 77)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_matches_pillow(tmp_path, size, subsampling, quality):
    _check(_jpeg(tmp_path, _picture(*size), quality=quality,
                 subsampling=subsampling))


@pytest.mark.parametrize("kw", [
    dict(subsampling=2, quality=90, restart_marker_blocks=3),
    dict(subsampling=1, quality=80, restart_marker_rows=1),
    dict(subsampling=0, quality=70, restart_marker_blocks=1),
    dict(subsampling=2, quality=85, optimize=True),
    dict(subsampling=2, quality=85, optimize=True, restart_marker_rows=2),
], ids=["420-rst3", "422-rst-row", "444-rst1", "420-optimize",
        "420-optimize-rst"])
def test_jpeg_restart_intervals_and_optimised_tables(tmp_path, kw):
    _check(_jpeg(tmp_path, _picture(61, 45, seed=1), **kw))


@pytest.mark.parametrize("kw", [dict(quality=80), dict(quality=95,
                                                       restart_marker_rows=1)],
                         ids=["plain", "rst"])
def test_jpeg_grayscale(tmp_path, kw):
    path = _jpeg(tmp_path, _picture(45, 61, seed=2)[..., 1], **kw)
    img, mode = jpeg.read_jpeg(path)
    assert mode == "L" and img.shape == (61, 45)
    np.testing.assert_array_equal(img, np.asarray(Image.open(path)))
    _check(path)


def test_jpeg_refuses_what_it_does_not_read(tmp_path):
    pic = _picture(32, 24, seed=3)
    prog = _jpeg(tmp_path, pic, "prog.jpg", progressive=True)
    with pytest.raises(ValueError, match=r"prog\.jpg.*progressive DCT"):
        jpeg.read_jpeg(prog)
    cmyk = tmp_path / "cmyk.jpg"
    Image.fromarray(pic).convert("CMYK").save(cmyk, "JPEG")
    with pytest.raises(ValueError, match=r"cmyk\.jpg.*4 components"):
        jpeg.read_jpeg(str(cmyk))
    base = _jpeg(tmp_path, pic, "base.jpg", quality=90)
    data = open(base, "rb").read()
    sof = data.index(b"\xff\xc0")
    arith = tmp_path / "arith.jpg"
    arith.write_bytes(data[:sof] + b"\xff\xc9" + data[sof + 2:])
    with pytest.raises(ValueError, match=r"arith\.jpg.*arithmetic-coded"):
        jpeg.read_jpeg(str(arith))
    deep = tmp_path / "deep.jpg"
    deep.write_bytes(data[:sof + 4] + b"\x0c" + data[sof + 5:])
    with pytest.raises(ValueError, match=r"deep\.jpg.*12-bit"):
        jpeg.read_jpeg(str(deep))
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(data[:-2])
    with pytest.raises(ValueError, match=r"cut\.jpg.*ends before its EOI"):
        jpeg.read_jpeg(str(cut))
    other = tmp_path / "other.gif"
    Image.fromarray(pic).save(other, "GIF")
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.read_jpeg(str(other))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        read_image(str(other))


# ---------------------------------------------------------------- PNG
def _encode_rows(img, ftypes, ctype):
    """A PNG whose row ``y`` uses filter ``ftypes[y]``."""
    h, w, c = img.shape
    a = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        up = a[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), a[y, :-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [np.zeros_like(left), left, up, (left + up) >> 1, paeth][ftypes[y]]
        rows.append(bytes([ftypes[y]]) + ((a[y] - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode,ctype,c", [("L", 0, 1), ("LA", 4, 2),
                                          ("RGB", 2, 3), ("RGBA", 6, 4)])
@pytest.mark.parametrize("shape", [(23, 37), (37, 23), (1, 9), (9, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_png_wavefront_on_mixed_row_filters(tmp_path, mode, ctype, c, shape):
    h, w = shape
    rng = np.random.RandomState(h * 100 + w + c)
    img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
    ftypes = rng.randint(0, 5, h)
    ftypes[: min(h, 5)] = np.arange(min(h, 5))  # every filter at least once
    path = tmp_path / "m.png"
    path.write_bytes(_encode_rows(img, ftypes.tolist(), ctype))
    got, got_mode = png.read_png(str(path))
    want = np.asarray(Image.open(path))
    assert got_mode == mode
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(h, w, c), img)


def test_png_reads_pillows_adaptive_filters(tmp_path):
    pic = _picture(160, 120, seed=4)
    alpha = (np.arange(160)[None, :] + np.arange(120)[:, None]) % 256
    rgba = np.concatenate([pic, alpha[..., None].astype(np.uint8)], -1)
    for mode, arr in (("RGBA", rgba), ("RGB", pic), ("L", pic[..., 0])):
        path = tmp_path / f"{mode}.png"
        Image.fromarray(arr, mode).save(path, optimize=True)
        got, got_mode = png.read_png(str(path))
        assert got_mode == mode
        np.testing.assert_array_equal(got, np.asarray(Image.open(path)))


def time_fern_size(path="fern_size.jpg"):
    """The host time of one ``read_jpeg`` of a JPEG at LLFF fern's size
    (4032x3024, quality 95, 4:2:0), written here with Pillow, beside
    Pillow's own decode; the two decodes compared bit for bit."""
    import time

    h, w = 3024, 4032
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(xx / 37), 128 + 100 * np.cos(yy / 29),
                     128 + 60 * np.sin((xx + yy) / 51)], -1)
    base += rng.normal(0, 6, base.shape)
    Image.fromarray(np.clip(base, 0, 255).astype(np.uint8)).save(
        path, "JPEG", quality=95, subsampling=2)
    t0 = time.perf_counter()
    want = np.asarray(Image.open(path).convert("RGB"))
    pil_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = read_image(path)
    port_s = time.perf_counter() - t0
    print(f"{w}x{h} q95 4:2:0 JPEG, {len(open(path, 'rb').read()):,} bytes: "
          f"data/jpeg.py {port_s:.2f} s, Pillow {pil_s:.3f} s, bit-equal "
          f"{np.array_equal(got, want)}")


if __name__ == "__main__":  # python tests/test_torch_port_jpeg.py
    time_fern_size()
