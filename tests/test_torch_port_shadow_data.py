"""The port's shadow data against the JAX package's (which reads and writes
through Pillow), on the CPU: the Gaussian blur and ``load_sm_image`` bit for
bit, ``generate_scene``'s JSON and pixels, and every buffer of the
``efficient_sm`` loader."""
import json
import os

import numpy as np
import pytest
from PIL import Image, ImageFilter

from nerf_pl_tpu.data import synthetic as jsyn
from nerf_pl_tpu.data.blender_efficient_sm import \
    BlenderEfficientShadows as JShadows
from nerf_pl_tpu.data.shadow_common import load_sm_image as j_load_sm
from nerf_pl_tpu_torch.data import dataset_dict, synthetic
from nerf_pl_tpu_torch.data.blender_efficient_sm import BlenderEfficientShadows
from nerf_pl_tpu_torch.data.blur import gaussian_blur
from nerf_pl_tpu_torch.data.png import write_png
from nerf_pl_tpu_torch.data.shadow_common import load_sm_image

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_gaussian_blur_bit_equal_to_pillow(mode):
    rng = np.random.RandomState(MODES[mode])
    for h, w in ((8, 8), (13, 21), (5, 3), (1, 7)):
        for radius in (0, 0.5, 1, 1.7, 3, 10, 40):
            img = rng.randint(0, 256, (h, w, MODES[mode])).astype(np.uint8)
            if mode == "L":
                img = img[..., 0]
            ref = np.asarray(Image.fromarray(img, mode).filter(
                ImageFilter.GaussianBlur(radius)))
            np.testing.assert_array_equal(gaussian_blur(img, radius), ref,
                                          err_msg=f"{h}x{w} r={radius}")
    with pytest.raises(ValueError):
        gaussian_blur(np.zeros((2, 2), np.float32), 1)


def _sm_pngs(root, wh):
    """A shadow-map-like PNG of each mode: hard shadow edges, noise, and an
    alpha channel that is partly 0 and partly 255."""
    rng = np.random.RandomState(wh)
    yy, xx = np.mgrid[0:wh, 0:wh]
    base = np.where((xx - wh / 2) ** 2 + (yy - wh / 3) ** 2 < (wh / 4) ** 2,
                    255, 30)
    paths = {}
    for mode, ch in MODES.items():
        img = np.clip(base[..., None] + rng.randint(-25, 25, (wh, wh, ch)), 0,
                      255).astype(np.uint8)
        if mode in ("LA", "RGBA"):
            img[..., -1] = np.where(xx < wh // 3, 0, np.where(
                xx > 2 * wh // 3, 255, rng.randint(0, 256, (wh, wh))))
        if mode == "L":
            img = img[..., 0]
        paths[mode] = os.path.join(root, f"sm_{mode}.png")
        write_png(paths[mode], img)
    return paths


@pytest.mark.parametrize("blur", [-1, 1, 3])
@pytest.mark.parametrize("size", [(8, 8), (20, 20), (32, 32)],
                         ids=["down", "same", "up"])
def test_load_sm_image_bit_equal_to_pillow(tmp_path, size, blur):
    for mode, path in _sm_pngs(str(tmp_path), 20).items():
        got = load_sm_image(path, size, blur)
        ref = j_load_sm(path, size, blur)
        assert got.dtype == np.float32 and got.shape == (size[0] * size[1], 3)
        np.testing.assert_array_equal(got, ref, err_msg=mode)


def test_generate_scene_matches_jax(tmp_path):
    kw = dict(img_wh=16, n_train=3, n_val=1, n_test=1)
    mine = synthetic.generate_scene(str(tmp_path / "torch"), **kw)
    ref = jsyn.generate_scene(str(tmp_path / "jax"), **kw)
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(mine)) == names
    assert len([n for n in names if n.startswith("sm_")]) == 5
    for name in names:
        a, b = os.path.join(mine, name), os.path.join(ref, name)
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), name
        else:
            ia, ib = Image.open(a), Image.open(b)
            assert ia.mode == ib.mode, name
            np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib), name)
    # the scene has shadows and ground under the light
    sm = np.asarray(Image.open(os.path.join(mine, "sm_r_train_0.png")))
    assert 0 < (sm > 0).mean() < 0.5


@pytest.fixture(scope="module")
def sm_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sm_scene"))
    synthetic.generate_scene(root, img_wh=16, n_train=3, n_val=2, n_test=1)
    # a train frame and a val frame without a shadow map: both are skipped
    os.remove(os.path.join(root, "sm_r_train_1.png"))
    os.remove(os.path.join(root, "sm_r_val_1.png"))
    return root


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("white_pix", [-1.0, 0.5])
@pytest.mark.parametrize("blur", [-1, 1])
def test_efficient_sm_loader_matches_jax(sm_scene, white_pix, blur):
    assert dataset_dict["efficient_sm"] is BlenderEfficientShadows
    kw = dict(img_wh=(8, 8), white_pix=white_pix, blur=blur)
    mine = BlenderEfficientShadows(sm_scene, "train", **kw)
    ref = JShadows(sm_scene, "train", **kw)
    for name in ("all_rays", "all_rgbs", "all_pixels", "pose_idx", "cam_ms",
                 "cam_eyes", "poses", "pixels", "directions"):
        _assert_same(getattr(mine, name), getattr(ref, name), name)
    for name in ("rays", "pixels", "camera", "eye_pos", "l2w"):
        _assert_same(getattr(mine.light, name), getattr(ref.light, name),
                     f"light.{name}")
    assert mine.focal == ref.focal and mine.light.focal == ref.light.focal
    assert len(mine) == len(ref) == mine.all_rays.shape[0]
    assert mine.cam_ms.shape[0] == 2  # the frame without a target is skipped
    if white_pix == -1.0:
        assert len(mine) == 2 * 64
    else:
        assert 0 < len(mine) < 2 * 64
    for idx in (0, len(mine) - 1):
        a, b = mine[idx], ref[idx]
        for key in ("rays", "pixels", "rgbs", "light_pixels", "light_rays"):
            _assert_same(a[key], b[key], key)
        for key in ("ppc", "light_ppc"):
            for sub in ("eye_pos", "camera"):
                _assert_same(a[key][sub], b[key][sub], f"{key}.{sub}")

    val, jval = (cls(sm_scene, "val", **kw) for cls in
                 (BlenderEfficientShadows, JShadows))
    assert len(val) == len(jval) == 1
    a, b = val[0], jval[0]
    for key in ("rays", "pixels", "rgbs", "light_pixels", "light_rays"):
        _assert_same(a[key], b[key], f"val {key}")
    for sub in ("eye_pos", "camera"):
        _assert_same(a["ppc"][sub], b["ppc"][sub], f"val ppc.{sub}")


def test_efficient_sm_loader_rejects_what_is_not_ported(sm_scene):
    # per-host frame shards (ported): this host's frames, the pose tables
    # whole and pose_idx global, as the JAX loader's
    for shard in ((0, 2), (1, 2)):
        mine = BlenderEfficientShadows(sm_scene, "train", img_wh=(8, 8),
                                       frame_shard=shard)
        ref = JShadows(sm_scene, "train", img_wh=(8, 8), frame_shard=shard)
        for key in ("all_rays", "all_rgbs", "all_pixels", "pose_idx",
                    "cam_ms", "cam_eyes"):
            assert np.array_equal(getattr(mine, key), getattr(ref, key)), key
    with pytest.raises(ValueError, match="width must equal"):
        BlenderEfficientShadows(sm_scene, "train", img_wh=(8, 6))
