"""The port's ``rgb_sm``, ``shadows`` and ``pyredner2`` loaders against the
JAX package's (which read through Pillow), bit for bit, on scenes the JAX
generators write; ``generate_pyredner_scene`` against the JAX generator; and
``EfficientSMSystem`` training on ``pyredner2`` through its CLI."""
import json
import os

import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu.data import synthetic as jsyn
from nerf_pl_tpu.data.blender_rgb_shadows import \
    BlenderRGBEfficientShadows as JRGBSM
from nerf_pl_tpu.data.blender_shadows import BlenderDatasetShadows as JShadows
from nerf_pl_tpu.data.pyredner2 import PyRednerShadowsDataset as JPyRedner
from nerf_pl_tpu.training import checkpoints as jckpt
from nerf_pl_tpu_torch.data import dataset_dict, synthetic
from nerf_pl_tpu_torch.data.blender_rgb_shadows import BlenderRGBEfficientShadows
from nerf_pl_tpu_torch.data.blender_shadows import BlenderDatasetShadows
from nerf_pl_tpu_torch.data.pyredner2 import PyRednerShadowsDataset
from nerf_pl_tpu_torch.train_efficient_sm import main as sm_main

WH = (8, 8)  # loaded from 16x16 frames: the LANCZOS resize is on the path


@pytest.fixture(scope="module")
def blender_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rgb_sm_scene"))
    jsyn.generate_scene(root, img_wh=16, n_train=5, n_val=3, n_test=1)
    # frames without a shadow map are skipped by rgb_sm (train and val)
    os.remove(os.path.join(root, "sm_r_train_3.png"))
    os.remove(os.path.join(root, "sm_r_val_1.png"))
    return root


@pytest.fixture(scope="module")
def pyredner_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pyredner_scene"))
    return jsyn.generate_pyredner_scene(root, img_wh=16, n_train=3, n_val=1,
                                        n_test=1)


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_items_same(a, b, what):
    for key in sorted(set(a) | set(b)):
        if isinstance(b[key], dict):
            for sub in b[key]:
                _assert_same(a[key][sub], b[key][sub], f"{what} {key}.{sub}")
        else:
            _assert_same(a[key], b[key], f"{what} {key}")


def _assert_light_same(mine, ref):
    for name in ("rays", "pixels", "camera", "eye_pos", "l2w"):
        _assert_same(getattr(mine.light, name), getattr(ref.light, name),
                     f"light.{name}")
    assert mine.light.focal == ref.light.focal
    assert (mine.light.near, mine.light.far) == (ref.light.near, ref.light.far)


def test_registry_has_the_shadow_loaders():
    assert dataset_dict["rgb_sm"] is BlenderRGBEfficientShadows
    assert dataset_dict["shadows"] is BlenderDatasetShadows
    assert dataset_dict["pyredner2"] is PyRednerShadowsDataset


@pytest.mark.parametrize("max_images,seed,blur", [(100, 0, -1), (3, 7, 2),
                                                  (-1, 0, -1)])
def test_rgb_sm_loader_bit_equal_to_jax(blender_scene, max_images, seed, blur):
    kw = dict(img_wh=WH, max_images=max_images, seed=seed, blur=blur)
    mine = BlenderRGBEfficientShadows(blender_scene, "train", **kw)
    ref = JRGBSM(blender_scene, "train", **kw)
    # max_images' shuffle keeps JAX's frame order and subset
    assert ([f["file_path"] for f in mine.meta["frames"]]
            == [f["file_path"] for f in ref.meta["frames"]])
    for name in ("all_rays", "all_rgbs", "all_sm", "all_pixels", "pose_idx",
                 "cam_ms", "cam_eyes", "poses", "pixels", "directions"):
        _assert_same(getattr(mine, name), getattr(ref, name), name)
    _assert_light_same(mine, ref)
    assert mine.focal == ref.focal and mine.white_back and ref.white_back
    n_kept = 3 if max_images == 3 else 4  # train_3 has no shadow map
    assert mine.cam_ms.shape[0] <= n_kept and len(mine) == len(ref)
    for idx in (0, len(mine) - 1):
        _assert_items_same(mine[idx], ref[idx], f"train[{idx}]")
    # the photo differs from the shadow map: both targets are on every ray
    assert not np.array_equal(mine.all_rgbs, mine.all_sm)

    val, jval = (cls(blender_scene, "val", **kw) for cls in
                 (BlenderRGBEfficientShadows, JRGBSM))
    assert val.max_images == 25
    assert len(val) == len(jval) == 2
    for i in range(len(val)):
        _assert_items_same(val[i], jval[i], f"val[{i}]")


def test_shadows_loader_bit_equal_to_jax(blender_scene):
    for split in ("train", "val"):
        mine = BlenderDatasetShadows(blender_scene, split, img_wh=WH)
        ref = JShadows(blender_scene, split, img_wh=WH)
        assert len(mine) == len(ref)
        assert not mine.white_back and not ref.white_back
        _assert_light_same(mine, ref)
        # the light samples from 100 to 500; the camera from 1 to 200
        assert mine.light.rays[0, 6:].tolist() == [100.0, 500.0]
        assert mine[0]["rays"][0, 6:].tolist() == [1.0, 200.0]
        # every frame but those whose shadow map was removed
        for idx in {"train": (0, 4), "val": (0, 2)}[split]:
            _assert_items_same(mine[idx], ref[idx], f"{split}[{idx}]")


def test_generate_pyredner_scene_matches_jax(tmp_path):
    kw = dict(img_wh=8, n_train=2, n_val=1, n_test=1)
    mine = synthetic.generate_pyredner_scene(str(tmp_path / "torch"), **kw)
    ref = jsyn.generate_pyredner_scene(str(tmp_path / "jax"), **kw)
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(mine)) == names
    for name in names:
        a, b = os.path.join(mine, name), os.path.join(ref, name)
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                ja, jb = json.load(fa), json.load(fb)
            assert ja == jb, name
            assert "look_at" in ja and "sm_file_path" in ja["frames"][0]
        else:
            ia, ib = Image.open(a), Image.open(b)
            assert ia.mode == ib.mode, name
            np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib), name)


@pytest.mark.parametrize("trans", [(False, False), (True, False),
                                   (False, True), (True, True)],
                         ids=["none", "trans", "trans2", "both"])
@pytest.mark.parametrize("blur", [-1, 0, 2])
def test_pyredner2_loader_bit_equal_to_jax(pyredner_scene, trans, blur):
    kw = dict(img_wh=WH, coords_trans=trans[0], coords_trans2=trans[1],
              blur=blur)
    mine = PyRednerShadowsDataset(pyredner_scene, "train", **kw)
    ref = JPyRedner(pyredner_scene, "train", **kw)
    # any blur but 0 has the fixed radius 5, the default -1 included
    assert mine.blur == ref.blur == (-1 if blur == 0 else 5)
    for name in ("all_rays", "all_rgbs", "all_pixels", "pose_idx", "cam_ms",
                 "cam_eyes", "pixels", "directions"):
        _assert_same(getattr(mine, name), getattr(ref, name), name)
    _assert_light_same(mine, ref)
    for idx in (0, len(mine) - 1):
        _assert_items_same(mine[idx], ref[idx], f"train[{idx}]")
    val, jval = (cls(pyredner_scene, "val", **kw) for cls in
                 (PyRednerShadowsDataset, JPyRedner))
    assert len(val) == len(jval) == 1
    _assert_items_same(val[0], jval[0], "val[0]")


def test_pyredner2_flips_and_blur_change_the_data(pyredner_scene, tmp_path):
    """The cases above are not vacuous: each flip moves the rays, and the
    blur the targets; without a flip, the look-at c2w gives the rays of the
    poses the scene was rendered from."""
    def load(**kw):
        return PyRednerShadowsDataset(pyredner_scene, "train", img_wh=WH, **kw)

    plain = load(blur=0)
    rays = {k: load(blur=0, **kw).all_rays for k, kw in (
        ("trans", dict(coords_trans=True)), ("trans2", dict(coords_trans2=True)))}
    assert not np.array_equal(plain.all_rays, rays["trans"])
    assert not np.array_equal(plain.all_rays, rays["trans2"])
    assert not np.array_equal(rays["trans"], rays["trans2"])
    assert not np.array_equal(plain.all_rgbs, load().all_rgbs)
    same = jsyn.generate_scene(str(tmp_path / "blender"), img_wh=16,
                               n_train=3, n_val=1, n_test=1)
    blender = dataset_dict["efficient_sm"](same, "train", img_wh=WH)
    np.testing.assert_allclose(plain.all_rays, blender.all_rays, atol=1e-6)
    # (the stored PPCs are used verbatim: they are the generator's, at the
    # 16x16 it wrote, not the loaded 8x8's; the JAX loader does the same)


def test_loaders_reject_what_is_not_ported(blender_scene):
    # per-host frame shards (ported): this host's frames, as the JAX
    # loader's
    from nerf_pl_tpu.data.blender_rgb_shadows import \
        BlenderRGBEfficientShadows as JRGB

    for shard in ((0, 2), (1, 2)):
        mine = BlenderRGBEfficientShadows(blender_scene, "train", img_wh=WH,
                                          frame_shard=shard)
        ref = JRGB(blender_scene, "train", img_wh=WH, frame_shard=shard)
        for key in ("all_rays", "all_rgbs", "all_sm", "all_pixels",
                    "pose_idx", "cam_ms"):
            assert np.array_equal(getattr(mine, key), getattr(ref, key)), key
    for cls in (BlenderRGBEfficientShadows, BlenderDatasetShadows):
        with pytest.raises(ValueError, match="width must equal"):
            cls(blender_scene, "train", img_wh=(8, 6))


def test_efficient_sm_trains_on_pyredner2(pyredner_scene, tmp_path, capsys):
    argv = ["--root_dir", pyredner_scene, "--dataset_name", "pyredner2",
            "--img_wh", "8", "8", "--N_samples", "8", "--N_importance", "8",
            "--batch_size", "64", "--num_epochs", "2", "--chunk", "128",
            "--lr", "5e-4", "--noise_std", "0", "--grad_on_light",
            "--Light_N_importance", "8", "--coords_trans2",
            "--shadow_method", "shadow_method_2", "--exp_name", "pr",
            "--arch_width", "32", "--log_dir", str(tmp_path / "logs"),
            "--ckpt_dir", str(tmp_path / "ckpts"), "--device", "cpu"]
    system = sm_main(argv)
    out = capsys.readouterr().out
    assert "epoch 1: sm_loss" in out
    assert type(system.train_dataset).__name__ == "PyRednerShadowsDataset"
    assert system.train_dataset.coords_trans and system.num_poses == 3
    ref = JPyRedner(pyredner_scene, "train", img_wh=WH, coords_trans2=True)
    np.testing.assert_array_equal(system.rays.numpy(), ref.all_rays)
    np.testing.assert_array_equal(system.light_m.numpy(), ref.light.camera)
    raw = jckpt.load_checkpoint(str(tmp_path / "ckpts" / "pr" / "epoch=1.ckpt"))
    assert int(raw["epoch"]) == 1
    with open(tmp_path / "logs" / "pr" / "metrics.jsonl") as f:
        losses = [json.loads(line).get("train/loss") for line in f]
    assert all(np.isfinite(v) for v in losses if v is not None)
