"""Whole datasets of the port against the JAX package's on images in the
layouts the new readers take: LLFF on progressive (Huffman and arithmetic)
and lossless JPEGs and on WebP views, Blender on 16-bit RGBA PNGs with a
palette + tRNS Adam7 view and on 16-bit TIFFs, ``efficient_sm`` on palette
shadow maps (which Pillow, and so both loaders, refuse to blur) and on
BMP, PPM and GIF maps.  Every array bit for bit.
"""
import glob
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu.data.blender import BlenderDataset as JaxBlender
from nerf_pl_tpu.data.blender_efficient_sm import \
    BlenderEfficientShadows as JShadows
from nerf_pl_tpu.data.llff import LLFFDataset as JLLFF
from nerf_pl_tpu_torch.data import synthetic
from nerf_pl_tpu_torch.data.blender import BlenderDataset
from nerf_pl_tpu_torch.data.blender_efficient_sm import BlenderEfficientShadows
from nerf_pl_tpu_torch.data.llff import LLFFDataset

import image_writers as W


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_items(mine, ref, what):
    assert len(mine) == len(ref), what
    for i in range(len(mine)):
        a, b = mine[i], ref[i]
        assert sorted(a) == sorted(b), what
        for k in a:
            if isinstance(a[k], dict):
                for s in a[k]:
                    _same(a[k][s], b[k][s], f"{what}[{i}].{k}.{s}")
            else:
                _same(a[k], b[k], f"{what}[{i}].{k}")


def test_llff_on_progressive_arithmetic_and_lossless_jpegs(tmp_path):
    root = synthetic.generate_llff_scene(str(tmp_path / "llff"),
                                         img_wh=(24, 18), n_views=4)
    for i, path in enumerate(sorted(glob.glob(os.path.join(root, "images",
                                                           "*.png")))):
        rgb = np.asarray(Image.open(path)).astype(np.float64)
        out = path[:-4] + ".jpg"
        if i == 0:
            Image.open(path).save(out, "JPEG", quality=90, progressive=True)
        else:
            f = W.frame_from_planes(W.rgb_to_ycc(rgb), [(2, 2), (1, 1), (1, 1)],
                                    85)
            data = (W.jpeg_bytes(f, progressive=True) if i == 1 else
                    W.jpeg_bytes(f, coding="arith", progressive=True) if i == 2
                    else W.lossless_bytes([rgb[..., c].astype(np.uint8)
                                           for c in range(3)], predictor=5))
            with open(out, "wb") as fh:
                fh.write(data)
        os.remove(path)
    for split in ("train", "val"):
        for wh in ((24, 18), (16, 12)):
            mine = LLFFDataset(root, split=split, img_wh=wh)
            ref = JLLFF(root, split=split, img_wh=wh)
            if split == "train":
                _same(mine.all_rays, ref.all_rays, "all_rays")
                _same(mine.all_rgbs, ref.all_rgbs, "all_rgbs")
            else:
                _same_items(mine, ref, f"val {wh}")


@pytest.fixture(scope="module")
def shadow_scene(tmp_path_factory):
    return synthetic.generate_scene(str(tmp_path_factory.mktemp("shadow")),
                                    img_wh=16, n_train=3, n_val=1, n_test=1)


@pytest.mark.parametrize("bw", [False, True], ids=["rgb", "black_and_white"])
def test_blender_on_16_bit_and_palette_pngs(shadow_scene, tmp_path, bw):
    root = str(tmp_path / "b16")
    shutil.copytree(shadow_scene, root)
    layouts = ["rgba16", "rgba16", "palette-adam7"]
    for i, layout in enumerate(layouts):
        path = os.path.join(root, f"r_train_{i}.png")
        W.png_as(path, path, layout, seed=i)
    path = os.path.join(root, "r_val_0.png")
    W.png_as(path, path, "rgba16", seed=9)
    assert Image.open(os.path.join(root, "r_train_0.png")).mode == "RGBA"
    assert Image.open(os.path.join(root, "r_train_2.png")).mode == "P"
    for wh in ((16, 16), (8, 8)):
        kw = dict(img_wh=wh, near=1.0, far=12.0, black_and_white=bw)
        mine, ref = BlenderDataset(root, "train", **kw), JaxBlender(root, "train", **kw)
        _same(mine.all_rays, ref.all_rays, "all_rays")
        _same(mine.all_rgbs, ref.all_rgbs, "all_rgbs")
        _same_items(BlenderDataset(root, "val", **kw),
                    JaxBlender(root, "val", **kw), f"val {wh}")


def test_efficient_sm_on_palette_shadow_maps(shadow_scene, tmp_path):
    root = str(tmp_path / "pal")
    shutil.copytree(shadow_scene, root)
    for path in glob.glob(os.path.join(root, "sm_*.png")):
        W.png_as(path, path, "palette")
        assert Image.open(path).mode == "P"
    for wh in ((16, 16), (8, 8)):
        kw = dict(img_wh=wh, white_pix=-1.0, blur=-1)
        mine = BlenderEfficientShadows(root, "train", **kw)
        ref = JShadows(root, "train", **kw)
        for name in ("all_rays", "all_rgbs", "all_pixels", "pose_idx"):
            _same(getattr(mine, name), getattr(ref, name), name)
        _same_items(BlenderEfficientShadows(root, "val", **kw),
                    JShadows(root, "val", **kw), f"val {wh}")
    # Pillow's GaussianBlur refuses a palette image: so do both loaders
    with pytest.raises(ValueError, match="wrong mode"):
        JShadows(root, "train", img_wh=(16, 16), blur=1)
    with pytest.raises(ValueError, match=r"sm_r_train_0\.png: image has wrong mode"):
        BlenderEfficientShadows(root, "train", img_wh=(16, 16), blur=1)


def test_llff_on_webp_views(tmp_path):
    """LLFF on WebP views: Pillow's lossy and lossless files, a VP8L file
    of the tests' writer (subtract-green and predictor transforms) and a
    lossy one at another quality; every array bit for bit."""
    root = synthetic.generate_llff_scene(str(tmp_path / "llff"),
                                         img_wh=(24, 18), n_views=4)
    for i, path in enumerate(sorted(glob.glob(os.path.join(root, "images",
                                                           "*.png")))):
        rgb = np.asarray(Image.open(path))
        out = path[:-4] + ".webp"
        if i == 1:
            Image.fromarray(rgb).save(out, "WEBP", lossless=True)
        elif i == 2:
            rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255,
                                                np.uint8)], -1)
            with open(out, "wb") as fh:
                fh.write(W.webp_container(W.vp8l_bytes(
                    rgba, ("subtract_green", "predictor"), alpha_hint=False),
                    b"VP8L"))
        else:
            Image.fromarray(rgb).save(out, "WEBP", quality=80 if i == 0 else 40)
        os.remove(path)
    for split in ("train", "val"):
        for wh in ((24, 18), (16, 12)):
            mine = LLFFDataset(root, split=split, img_wh=wh)
            ref = JLLFF(root, split=split, img_wh=wh)
            if split == "train":
                _same(mine.all_rays, ref.all_rays, "all_rays")
                _same(mine.all_rgbs, ref.all_rgbs, "all_rgbs")
            else:
                _same_items(mine, ref, f"val {wh}")


@pytest.mark.parametrize("bw", [False, True], ids=["rgb", "black_and_white"])
def test_blender_on_16_bit_tiffs(shadow_scene, tmp_path, bw):
    """Blender on TIFF frames under their ``.png`` names: 16-bit RGBA (each
    value ``v * 257``, so its high bytes are the PNG's) with LZW and
    predictor 2 in strips, one in 8x8 tiles, one big-endian Deflate, and
    the val frame 8-bit RGBA with associated alpha."""
    from nerf_pl_tpu_torch.data.png import read_png

    root = str(tmp_path / "tiff")
    shutil.copytree(shadow_scene, root)
    for i in range(3):
        path = os.path.join(root, f"r_train_{i}.png")
        img, _ = read_png(path)
        wide = img.astype(np.uint16) * 257
        kw = [dict(compression=5, predictor=2, rows_per_strip=5),
              dict(compression=5, predictor=2, tile=(8, 8)),
              dict(compression=8, predictor=2, order="MM")][i]
        with open(path, "wb") as fh:
            fh.write(W.tiff_bytes(wide, 2, 16, extra=(2,), **kw))
    path = os.path.join(root, "r_val_0.png")
    img, _ = read_png(path)
    img[..., :3] = np.minimum(img[..., :3], img[..., 3:])  # associated
    with open(path, "wb") as fh:
        fh.write(W.tiff_bytes(img, 2, 8, extra=(1,), compression=32773))
    assert Image.open(os.path.join(root, "r_train_0.png")).format == "TIFF"
    for wh in ((16, 16), (8, 8)):
        kw = dict(img_wh=wh, near=1.0, far=12.0, black_and_white=bw)
        mine, ref = BlenderDataset(root, "train", **kw), JaxBlender(root, "train", **kw)
        _same(mine.all_rays, ref.all_rays, "all_rays")
        _same(mine.all_rgbs, ref.all_rgbs, "all_rgbs")
        _same_items(BlenderDataset(root, "val", **kw),
                    JaxBlender(root, "val", **kw), f"val {wh}")


def test_efficient_sm_on_bmp_ppm_gif_maps(shadow_scene, tmp_path):
    """``efficient_sm`` on shadow maps stored as BMP, PPM and GIF under
    their ``sm_*.png`` names; blurred too, where Pillow refuses the GIF's
    palette image as it does a palette PNG."""
    from nerf_pl_tpu_torch.data.png import read_png

    root = str(tmp_path / "maps")
    shutil.copytree(shadow_scene, root)
    kinds = []
    for k, path in enumerate(sorted(glob.glob(os.path.join(root, "sm_*.png")))):
        img, _ = read_png(path)
        if k % 3 == 0:
            data = W.bmp_bytes(img, 24)
        elif k % 3 == 1:
            data = W.ppm_bytes(img, b"P6")
        else:
            idx, pal, _ = W.palette_of(img)
            data = W.gif_bytes(idx, pal)
        with open(path, "wb") as fh:
            fh.write(data)
        kinds.append(Image.open(path).format)
    assert set(kinds) == {"BMP", "PPM", "GIF"}
    for wh in ((16, 16), (8, 8)):
        kw = dict(img_wh=wh, white_pix=-1.0, blur=-1)
        mine = BlenderEfficientShadows(root, "train", **kw)
        ref = JShadows(root, "train", **kw)
        for name in ("all_rays", "all_rgbs", "all_pixels", "pose_idx"):
            _same(getattr(mine, name), getattr(ref, name), name)
        _same_items(BlenderEfficientShadows(root, "val", **kw),
                    JShadows(root, "val", **kw), f"val {wh}")
    with pytest.raises(ValueError, match="wrong mode"):
        JShadows(root, "train", img_wh=(16, 16), blur=1)
    with pytest.raises(ValueError, match=r"\.png: image has wrong mode"):
        BlenderEfficientShadows(root, "train", img_wh=(16, 16), blur=1)
