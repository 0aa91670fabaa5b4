"""``LAB`` pictures converted as Pillow converts them, through LittleCMS.

The port's ``LAB`` -> ``RGB`` and ``RGBA`` (``data/lcms.py``: the 33-node
CLUT LittleCMS 2.17 samples for Pillow's transform, interpolated per pixel
by ``csrc/lcms_transform.cpp``) against Pillow's on every one of the 2^24
``LAB`` values; the C++ stage against its plain version; ``LAB`` to ``L``
raising as Pillow raises; and ``LAB`` PSDs and TIFFs (contiguous, whose
a and b Pillow's unpacker flips, and in separate planes, whose bands it
reads as they are) through the JAX loader functions.
"""
import io

import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu_torch.data import image as port_image
from nerf_pl_tpu_torch.data import lcms

import image_writers as W
from test_torch_port_images import WH, hold_loaders

_FLIP = np.array([0, 128, 128], np.uint8)  # core bytes <-> Pillow's array


def _every_value():
    g = np.arange(256, dtype=np.uint8)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(
        4096, 4096, 3)


def _pillow(core: np.ndarray, mode: str) -> np.ndarray:
    """Pillow's conversion of a core image holding ``core``'s bytes (the
    ``LAB`` raw mode flips a and b, as its packer flips them back)."""
    h, w = core.shape[:2]
    im = Image.frombytes("LAB", (w, h), (core ^ _FLIP).tobytes())
    return np.asarray(im.convert(mode))


def test_lab_to_rgb_equals_pillow_on_every_value():
    """All 2^24 core ``LAB`` values: ``RGB`` and ``RGBA`` bit for bit (the
    alpha is the core image's fourth byte, 255 from the ``LAB`` unpacker)."""
    core = _every_value()
    got = lcms.lab_to_rgb(core)
    np.testing.assert_array_equal(got, _pillow(core, "RGB"))
    rgba = _pillow(core, "RGBA")
    np.testing.assert_array_equal(got, rgba[..., :3])
    assert (rgba[..., 3] == 255).all()
    pic = port_image.Picture(core ^ _FLIP, "LAB", pad=255)
    np.testing.assert_array_equal(port_image.convert(pic, "RGBA"), rgba)


def test_lab_stage_equals_plain():
    """The C++ stage and the numpy one on a seeded 2^16 values, every
    8-bit value at a CLUT node (L, a, b in 0, 8, ..., 248, 255) and the
    neutral axis."""
    rng = np.random.RandomState(22)
    near = np.r_[np.arange(0, 256, 8), 255].astype(np.uint8)
    nodes = np.stack(np.meshgrid(near, near, near, indexing="ij"), -1)
    neutral = np.stack([np.arange(256), np.full(256, 128),
                        np.full(256, 128)], -1)
    px = np.concatenate([rng.randint(0, 256, (1 << 16, 3)),
                         nodes.reshape(-1, 3), neutral]).astype(np.uint8)
    np.testing.assert_array_equal(lcms.lab_to_rgb(px),
                                  lcms.lab_to_rgb_plain(px))
    # a stride of four bytes (the core's pad) reads the same
    padded = np.concatenate([px, np.zeros((len(px), 1), np.uint8)], -1)
    np.testing.assert_array_equal(lcms.lab_to_rgb(padded), lcms.lab_to_rgb(px))


def test_lab_to_l_raises_as_pillow(tmp_path):
    rng = np.random.RandomState(3)
    path = tmp_path / "lab.psd"
    path.write_bytes(W.psd_bytes(rng.randint(0, 256, (3, 6, 8)), 9))
    with pytest.raises(ValueError) as want:
        Image.open(path).convert("L")
    pic = port_image.read_picture(str(path))
    with pytest.raises(ValueError, match=str(want.value)):
        port_image.convert(pic, "L")


def _lab_files():
    rng = np.random.RandomState(4)
    w, h = WH
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([(xx * 6 + yy) % 256, (xx * 3 + 128) % 256,
                       (yy * 7 + 64) % 256])
    planes = np.where(rng.rand(3, h, w) < 0.5, smooth,
                      rng.randint(0, 256, (3, h, w))).astype(np.uint8)
    s = planes.transpose(1, 2, 0)
    return [
        ("psd-raw", W.psd_bytes(planes, 9, compression=0)),
        ("psd-packbits", W.psd_bytes(planes, 9)),
        ("tiff-raw", W.tiff_bytes(s, 8, 8)),
        ("tiff-lzw", W.tiff_bytes(s, 8, 8, compression=5, rows_per_strip=7)),
        ("tiff-tiles", W.tiff_bytes(s, 8, 8, compression=8, tile=(16, 16))),
        ("tiff-planes", W.tiff_bytes(s, 8, 8, planar=2)),
        ("tiff-o3", W.tiff_bytes(s, 8, 8, tags=[(274, "H", [3])])),
    ]


LAB_FILES = _lab_files()


@pytest.mark.parametrize("name,data", LAB_FILES, ids=[c[0] for c in LAB_FILES])
def test_lab_files_through_the_loaders(tmp_path, name, data):
    """``LAB`` PSDs and TIFFs: the picture, its ``RGB`` and ``RGBA`` (whose
    alpha is 255 from the TIFF's contiguous unpacker, 0 from bands read one
    by one), resized or not, and every JAX loader function against the
    port's."""
    path = tmp_path / f"{name}.img"
    path.write_bytes(data)
    pil = Image.open(path)
    pil.load()
    assert pil.mode == "LAB"
    pic = port_image.read_picture(str(path))
    np.testing.assert_array_equal(pic.pixels, np.asarray(pil))
    for size in (pil.size, (pil.size[0] // 2, pil.size[1] // 2)):
        small = pil.resize(size, Image.LANCZOS)
        mine = port_image.resize(pic, size)
        np.testing.assert_array_equal(mine.pixels, np.asarray(small))
        for mode in ("RGB", "RGBA"):
            np.testing.assert_array_equal(port_image.convert(mine, mode),
                                          np.asarray(small.convert(mode)))
    hold_loaders(str(path))


def test_lab_pillow_written_tiff(tmp_path):
    """Pillow's own ``LAB`` TIFF (its writer's signed a and b)."""
    rng = np.random.RandomState(5)
    im = Image.frombytes("LAB", WH, rng.randint(0, 256, WH[0] * WH[1] * 3)
                         .astype(np.uint8).tobytes())
    b = io.BytesIO()
    im.save(b, "TIFF", compression="tiff_lzw")
    path = tmp_path / "pillow-lab.tif"
    path.write_bytes(b.getvalue())
    pic = port_image.read_picture(str(path))
    for mode in ("RGB", "RGBA"):
        want = np.asarray(Image.open(path).convert(mode))
        np.testing.assert_array_equal(port_image.convert(pic, mode), want)
    hold_loaders(str(path))
