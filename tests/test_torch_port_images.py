"""The port's image loaders against the JAX package's, bit for bit, on every
PNG layout Pillow reads (``PngImagePlugin._MODES``: 1/2/4/8/16-bit gray,
8/16-bit RGB, gray + alpha and RGBA, 1/2/4/8-bit palette, with ``tRNS`` and
Adam7), written by ``tests/image_writers.py`` and each first read back by
Pillow.  Every layout goes through ``_load_image`` (colour and
``black_and_white``), ``_load_rgb``, ``load_sm_image`` (with and without a
blur) and the mesh tool's read, at its native size and at half of it.  Also
the two repairs: an RGB PNG's ``tRNS`` key colour (transparent under JAX,
opaque in the port before), and files opened by their content whatever
their name; and Pillow's chunk checks.
"""
import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu.data.blender import _load_image as j_load_image
from nerf_pl_tpu.data.llff import _load_rgb as j_load_rgb
from nerf_pl_tpu.data.shadow_common import load_sm_image as j_load_sm_image
from nerf_pl_tpu_torch.data import image as port_image
from nerf_pl_tpu_torch.data.blender import _load_image
from nerf_pl_tpu_torch.data.llff import _load_rgb
from nerf_pl_tpu_torch.data.shadow_common import load_sm_image
from nerf_pl_tpu_torch.tools.extract_mesh import _read_rgb

import image_writers as W

WH = (40, 30)  # native; the downscale is half of it (the aspect ratio kept)


def _mesh_read(path, wh):
    """``tools/extract_mesh.py``'s read of a view in the JAX package."""
    return np.array(Image.open(path).convert("RGB").resize(wh, Image.LANCZOS))


def _same(call_jax, call_port, what):
    """Both calls give the same array, or both raise ValueError."""
    try:
        want = call_jax()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            call_port()
        assert str(e) in str(got.value) or "wrong mode" in str(got.value), what
        return False
    got = call_port()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)
    return True


def hold_loaders(path, native=WH):
    """Every JAX loader function against the port's on ``path`` at its
    native size and at half of it."""
    assert Image.open(path).size == native
    for wh in (native, (native[0] // 2, native[1] // 2)):
        for bw in (False, True):
            _same(lambda: j_load_image(path, wh, bw),
                  lambda: _load_image(path, wh, bw), f"_load_image {wh} {bw}")
        _same(lambda: j_load_rgb(path, wh), lambda: _load_rgb(path, wh),
              f"_load_rgb {wh}")
        for blur in (-1, 2):
            _same(lambda: j_load_sm_image(path, wh, blur),
                  lambda: load_sm_image(path, wh, blur),
                  f"load_sm_image {wh} {blur}")
        _same(lambda: _mesh_read(path, wh), lambda: _read_rgb(path, wh),
              f"mesh read {wh}")


def _png_layouts():
    """(name, png bytes, Pillow's mode) for every PNG layout."""
    rng = np.random.RandomState(5)
    w, h = WH
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (xx * 5 + yy * 3) % 256  # runs and gradients, not only noise
    out = []
    for d in (1, 2, 4, 8, 16):
        top = (1 << d) - 1
        img = np.where(rng.rand(h, w) < 0.5, smooth * top // 255,
                       rng.randint(0, top + 1, (h, w)))
        key = int(img[1, 2]).to_bytes(2, "big")
        mode = {1: "1", 16: "I;16"}.get(d, "L")
        out += [(f"gray{d}", W.png_bytes(img, d, 0), mode),
                (f"gray{d}-trns", W.png_bytes(img, d, 0, trns=key), mode),
                (f"gray{d}-adam7", W.png_bytes(img, d, 0, interlace=True,
                                               trns=key), mode)]
    for d in (8, 16):
        for ctype, c, mode in ((2, 3, "RGB"), (4, 2, "LA" if d == 8 else "RGBA"),
                               (6, 4, "RGBA")):
            img = np.where(rng.rand(h, w, c) < 0.5,
                           smooth[..., None] * ((1 << d) - 1) // 255,
                           rng.randint(0, 1 << d, (h, w, c)))
            if c in (2, 4):  # transparent and opaque runs
                img[:8, :, -1] = 0
                img[8:16, :, -1] = (1 << d) - 1
            out += [(f"ct{ctype}-{d}", W.png_bytes(img, d, ctype), mode),
                    (f"ct{ctype}-{d}-adam7", W.png_bytes(img, d, ctype,
                                                         interlace=True), mode)]
            if ctype == 2:
                img[:3, :5] = img[0, 0]  # the key colour
                key = b"".join(int(v).to_bytes(2, "big") for v in img[0, 0])
                out.append((f"ct2-{d}-trns", W.png_bytes(img, d, 2, trns=key),
                            mode))
    for d in (1, 2, 4, 8):
        n = min(1 << d, 180)
        img = np.where(rng.rand(h, w) < 0.5, smooth * (n - 1) // 255,
                       rng.randint(0, n, (h, w)))
        pal = rng.randint(0, 256, (n, 3))
        simple = bytes([255] * (n // 2) + [0])  # one transparent entry
        alphas = bytes(rng.randint(0, 256, n // 2 + 1).tolist())
        out += [(f"pal{d}", W.png_bytes(img, d, 3, palette=pal), "P"),
                (f"pal{d}-trns1", W.png_bytes(img, d, 3, palette=pal,
                                              trns=simple), "P"),
                (f"pal{d}-alphas-adam7", W.png_bytes(
                    img, d, 3, palette=pal, trns=alphas, interlace=True), "P"),
                (f"pal{d}-short", W.png_bytes(img, d, 3,
                                              palette=pal[:max(1, n // 2)]), "P")]
    return out


PNG_LAYOUTS = _png_layouts()


@pytest.mark.parametrize("name,data,mode", PNG_LAYOUTS,
                         ids=[n for n, _, _ in PNG_LAYOUTS])
def test_png_layout_matches_jax_loaders(tmp_path, name, data, mode):
    path = str(tmp_path / f"{name}.png")
    with open(path, "wb") as f:
        f.write(data)
    pil = Image.open(path)
    assert pil.mode == mode  # the writer's file, read back by Pillow
    want = np.asarray(pil)
    pic = port_image.read_picture(path)
    assert pic.mode == mode
    np.testing.assert_array_equal(pic.pixels, want.astype(np.uint8) * 255
                                  if mode == "1" else want)
    assert pic.transparency == pil.info.get("transparency")
    hold_loaders(path)


def test_rgb_png_trns_key_is_transparent_as_in_jax(tmp_path):
    """An 8-bit RGB PNG whose ``tRNS`` names black: under JAX the black
    pixels get alpha 0 (so ``blend_rgba`` turns them white), at the native
    size and after a resize that keeps them black."""
    rng = np.random.RandomState(0)
    img = rng.randint(1, 256, (16, 16, 3)).astype(np.uint8)
    img[:8, :8] = 0
    path = str(tmp_path / "key.png")
    Image.fromarray(img).save(path, transparency=(0, 0, 0))
    for wh in ((16, 16), (8, 8)):
        want = j_load_image(path, wh)
        got = _load_image(path, wh)
        np.testing.assert_array_equal(got, want)
        assert (got[:, 3] == 0).sum() == (want[:, 3] == 0).sum()
    assert (j_load_image(path, (16, 16))[:, 3] == 0).sum() == 64


def test_loaders_open_files_by_content(tmp_path):
    """A JPEG saved under a ``.png`` name, and a PNG under ``.jpg``, load
    as Pillow opens them; other content raises, naming the file and its
    first bytes."""
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (WH[1], WH[0], 3)).astype(np.uint8)
    jpeg_as_png = str(tmp_path / "view.png")
    Image.fromarray(img).save(jpeg_as_png, "JPEG", quality=90)
    png_as_jpg = str(tmp_path / "view.jpg")
    Image.fromarray(img).save(png_as_jpg, "PNG")
    for path in (jpeg_as_png, png_as_jpg):
        hold_loaders(path)
    other = tmp_path / "junk.png"
    other.write_bytes(b"GIF89a\x01\x00junk")
    for load in (lambda p: _load_image(p, WH), lambda p: _load_rgb(p, WH),
                 lambda p: load_sm_image(p, WH), lambda p: _read_rgb(p, WH)):
        with pytest.raises(ValueError, match=r"junk\.png: neither a PNG nor a "
                                             r"JPEG file \(it starts b'GIF89a"):
            load(str(other))


def test_png_chunk_checks_as_pillow(tmp_path):
    """Pillow checks the CRCs of the chunks before the first IDAT only and
    reads a file that ends after its image data without IEND; so does the
    port.  A header that fails its CRC raises in both, naming the file."""
    import struct

    img = np.random.RandomState(2).randint(0, 256, (WH[1], WH[0], 3))
    data = W.png_bytes(img, 8, 2)
    i = data.index(b"IDAT")
    n = struct.unpack(">I", data[i - 4:i])[0]
    j = data.index(b"IHDR") + 4 + 13
    files = {"idat-crc": data[:i + 4 + n] + b"\0\0\0\0" + data[i + 8 + n:],
             "no-iend": data[:data.index(b"IEND") - 4],
             "ihdr-crc": data[:j] + b"\0\0\0\0" + data[j + 4:]}
    for name, body in files.items():
        (tmp_path / f"{name}.png").write_bytes(body)
    for name in ("idat-crc", "no-iend"):
        hold_loaders(str(tmp_path / f"{name}.png"))
    path = str(tmp_path / "ihdr-crc.png")
    with pytest.raises(OSError):  # PIL.UnidentifiedImageError
        Image.open(path)
    with pytest.raises(ValueError, match=r"ihdr-crc\.png: a corrupt PNG "
                                         r"\(PNG chunk b'IHDR' fails its CRC"):
        _load_image(path, WH)


@pytest.mark.parametrize("mode", ["L", "RGBA", "I;16"])
def test_resize_matches_pillow_at_many_sizes(mode):
    """LANCZOS in 8 bits (premultiplied with alpha) and in 16 bits for
    ``I;16`` against Pillow over random sizes, up and down, and 50x16 ->
    107x119, where Python's compensated ``sum()`` of the weights once put
    one 16-bit pixel a step off Pillow's in-order C sum."""
    from nerf_pl_tpu_torch.data.image import Picture, resize

    rng = np.random.RandomState(21)
    sizes = [((50, 16), (107, 119))] + [
        (tuple(rng.randint(1, 70, 2).tolist()), tuple(rng.randint(1, 90, 2).tolist()))
        for _ in range(12)]
    for (w, h), size in sizes:
        shape = (h, w, 4) if mode == "RGBA" else (h, w)
        top = 65536 if mode == "I;16" else 256
        img = rng.randint(0, top, shape).astype(np.uint16 if top > 256 else np.uint8)
        want = np.asarray(Image.fromarray(img, mode).resize(size, Image.LANCZOS))
        got = resize(Picture(img, mode), size).pixels
        np.testing.assert_array_equal(got, want, err_msg=f"{(w, h)} -> {size}")
