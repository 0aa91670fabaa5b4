"""The port's LLFF path against the JAX package on the CPU: the synthetic
forward-facing and ring scenes both generators write, the loader (poses,
bounds, focal, every split's rays and colours, the spiral and spheric test
paths, the val pick) on PNG and on a JPEG copy, NDC rays, one training step
in NDC, the training and eval CLIs with checkpoints both packages read,
``sample_pdf_bins`` and ``ssim``.

Tolerances: the loaders are bit-equal (the same numpy float ops, and image
readers and a LANCZOS resize bit-equal to Pillow's).  The training step
holds as ``tests/test_torch_port_train.py`` and
``tests/test_torch_port_shadows.py`` do: loss and PSNR to 1e-5 relative,
each grad to 1e-4 of its tensor's largest and 1e-5 on average (f32 sums in
another order).  Rendered PNGs within one level of 255 (a rounding edge).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_pl_tpu import config as jconfig
from nerf_pl_tpu.data.llff import LLFFDataset as JLLFF
from nerf_pl_tpu.data.synthetic import generate_llff_scene as jgenerate
from nerf_pl_tpu.ops import ray_utils as jray
from nerf_pl_tpu.ops.rendering import render_rays as jrender
from nerf_pl_tpu.ops.sampling import sample_pdf_bins as jsample_pdf_bins
from nerf_pl_tpu.tools import evaluate as jeval
from nerf_pl_tpu.training import checkpoints as jckpt
from nerf_pl_tpu.training import metrics as jmetrics
from nerf_pl_tpu.training.losses import mse_loss as jmse
from nerf_pl_tpu.training.metrics import psnr as jpsnr
from nerf_pl_tpu.training.trainer import NeRFSystem as JNeRFSystem
from nerf_pl_tpu.training.trainer import \
    render_kwargs_from_cfg as jrender_kwargs
from nerf_pl_tpu_torch import config as tconfig
from nerf_pl_tpu_torch.data import dataset_dict, png
from nerf_pl_tpu_torch.data.llff import LLFFDataset
from nerf_pl_tpu_torch.data.synthetic import generate_llff_scene
from nerf_pl_tpu_torch.eval import main as eval_main
from nerf_pl_tpu_torch.models.nerf import nerf_to_numpy
from nerf_pl_tpu_torch.ops import ray_utils
from nerf_pl_tpu_torch.ops.sampling import sample_pdf_bins
from nerf_pl_tpu_torch.train import main as train_main
from nerf_pl_tpu_torch.training import metrics
from nerf_pl_tpu_torch.training.trainer import NeRFSystem
from test_torch_port_shadow_rgb_sm import assert_grads_match, torch_ov
from test_torch_port_shadow_train import _draws, _params

WH, VIEWS = (24, 18), 5
SMALL = (16, 12)  # the same 4:3 aspect: the LANCZOS resize runs
NARROW = 32
LAYOUTS = ["fan", "ring"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The forward-facing fan and the ring, each written by both packages'
    generators."""
    root = tmp_path_factory.mktemp("llff")
    out = {}
    for layout in LAYOUTS:
        kw = dict(img_wh=WH, n_views=VIEWS, spheric=layout == "ring")
        out[layout] = (jgenerate(str(root / f"jax_{layout}"), **kw),
                       generate_llff_scene(str(root / f"port_{layout}"), **kw))
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_generators_write_the_same_scene(scenes, layout):
    jroot, root = scenes[layout]
    a = np.load(os.path.join(jroot, "poses_bounds.npy"))
    b = np.load(os.path.join(root, "poses_bounds.npy"))
    assert a.dtype == b.dtype == np.float64 and a.shape == (VIEWS, 17)
    np.testing.assert_array_equal(a, b)
    names = sorted(os.listdir(os.path.join(jroot, "images")))
    assert names == sorted(os.listdir(os.path.join(root, "images")))
    assert len(names) == VIEWS
    for name in names:
        want = np.asarray(Image.open(os.path.join(jroot, "images", name)))
        got, mode = png.read_png(os.path.join(root, "images", name))
        assert mode == "RGB"
        np.testing.assert_array_equal(got, want)


def _both(root, split, wh, spheric):
    return (JLLFF(root, split=split, img_wh=wh, spheric_poses=spheric),
            LLFFDataset(root, split=split, img_wh=wh, spheric_poses=spheric))


def _assert_same(j, p):
    np.testing.assert_array_equal(p.poses, j.poses)
    np.testing.assert_array_equal(p.pose_avg, j.pose_avg)
    np.testing.assert_array_equal(p.bounds, j.bounds)
    assert p.focal == j.focal and type(p.focal) is type(j.focal)
    np.testing.assert_array_equal(p.directions, j.directions)
    assert len(p) == len(j)
    if p.split == "train":
        np.testing.assert_array_equal(p.all_rays, j.all_rays)
        np.testing.assert_array_equal(p.all_rgbs, j.all_rgbs)
        assert p.all_rays.dtype == p.all_rgbs.dtype == np.float32
        return
    if p.split == "val":
        np.testing.assert_array_equal(p.c2w_val, j.c2w_val)
        assert p.image_path_val == j.image_path_val
    else:
        np.testing.assert_array_equal(p.poses_test, j.poses_test)
    for i in range(len(p)):
        a, b = p[i], j[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("split", ["train", "val", "test", "test_train"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_loader_matches_jax(scenes, layout, split):
    root = scenes[layout][1]
    spheric = layout == "ring"
    for wh in (WH, SMALL):
        j, p = _both(root, split, wh, spheric)
        _assert_same(j, p)
    if split == "test":
        assert len(p) == 120 and p.poses_test.shape == (120, 3, 4)
    if split == "val":
        # the pose nearest the centre (for the fan, its middle view)
        dist = np.linalg.norm(p.poses[:, :, 3], axis=1)
        assert p.val_idx == int(np.argmin(dist)) == (p.val_idx if spheric
                                                     else VIEWS // 2)
        assert p.image_path_val.endswith(f"{p.val_idx:03d}.png")
    if split == "train":
        near_far = p.all_rays[:, 6:]
        if spheric:
            near = p.bounds.min()
            assert np.all(near_far == np.float32([near, min(8 * near,
                                                             p.bounds.max())]))
        else:
            assert np.all(near_far == np.float32([0.0, 1.0]))
    assert LLFFDataset.white_back is False
    assert dataset_dict["llff"] is LLFFDataset


def test_loader_reads_a_jpeg_copy_as_pillow_does(scenes, tmp_path):
    """The same scene with its images as JPEGs of several layouts (4:2:0,
    4:2:2, 4:4:4, grayscale; restart markers; an optimised Huffman table):
    the port's decoder gives Pillow's bits, so the two loaders agree bit for
    bit."""
    src = scenes["fan"][0]
    root = tmp_path / "jpeg_scene"
    (root / "images").mkdir(parents=True)
    (root / "poses_bounds.npy").write_bytes(
        open(os.path.join(src, "poses_bounds.npy"), "rb").read())
    layouts = [dict(quality=95, subsampling=2),
               dict(quality=75, subsampling=1, restart_marker_blocks=2),
               dict(quality=90, subsampling=0, optimize=True),
               dict(quality=60, subsampling=2, restart_marker_rows=1),
               dict(quality=85, grey=True)]
    for i, kw in enumerate(layouts):
        img = Image.open(os.path.join(src, "images", f"{i:03d}.png"))
        if kw.pop("grey", False):
            img = img.convert("L")
        img.save(root / "images" / f"{i:03d}.jpg", "JPEG", **kw)
    for split in ("train", "val"):
        for wh in (WH, SMALL):
            j, p = _both(str(root), split, wh, False)
            _assert_same(j, p)


def test_loader_refuses_what_it_cannot_read(scenes, tmp_path):
    src = scenes["fan"][1]
    root = tmp_path / "bmp_scene"
    (root / "images").mkdir(parents=True)
    (root / "poses_bounds.npy").write_bytes(
        open(os.path.join(src, "poses_bounds.npy"), "rb").read())
    for i in range(VIEWS):
        Image.open(os.path.join(src, "images", f"{i:03d}.png")).save(
            root / "images" / f"{i:03d}.im")
    _assert_same(*_both(str(root), "train", WH, False))  # IM, as Pillow
    for i in range(VIEWS):
        os.remove(root / "images" / f"{i:03d}.im")
        Image.open(os.path.join(src, "images", f"{i:03d}.png")).save(
            root / "images" / f"{i:03d}.avif")
    with pytest.raises(ValueError, match=r"000\.avif: Pillow reads this as "
                                         r"AVIF, a format the port does not "
                                         r"read"):
        LLFFDataset(str(root), split="train", img_wh=WH)
    # per-host frame shards: the images of this host, as the JAX loader's
    for shard in ((0, 2), (1, 2)):
        mine = LLFFDataset(src, split="train", img_wh=WH, frame_shard=shard)
        ref = JLLFF(src, split="train", img_wh=WH, frame_shard=shard)
        assert np.array_equal(mine.all_rays, ref.all_rays)
        assert np.array_equal(mine.all_rgbs, ref.all_rgbs)
    with pytest.raises(ValueError, match="gets no images"):
        LLFFDataset(src, split="train", img_wh=WH, frame_shard=(9, 10))
    for cls in (JLLFF, LLFFDataset):
        with pytest.raises(AssertionError, match="same aspect ratio"):
            cls(src, split="train", img_wh=(24, 24))


def test_ndc_rays_match_jax():
    rng = np.random.RandomState(3)
    o = rng.normal(size=(64, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(1.0, 3.0, 64)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = jray.get_ndc_rays(18, 24, 20.5, 1.0, o, d)
    got = ray_utils.get_ndc_rays(18, 24, 20.5, 1.0, torch.from_numpy(o),
                                 torch.from_numpy(d))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


# ------------------------------------------------------------- training
def _kw(root, tmp, **kw):
    base = dict(root_dir=root, dataset_name="llff", img_wh=SMALL,
                N_samples=8, N_importance=8, batch_size=32, num_epochs=2,
                chunk=128, lr=5e-4, exp_name="t", log_dir=str(tmp / "logs"),
                ckpt_dir=str(tmp / "ckpts"), num_sanity_val_steps=0,
                num_devices=1, arch_width=NARROW)
    base.update(kw)
    return base


@pytest.mark.parametrize("layout", LAYOUTS)
def test_one_llff_step_matches_a_jax_step(scenes, tmp_path, layout):
    root = scenes[layout][1]
    kw = dict(spheric_poses=layout == "ring", perturb=1.0, noise_std=1.0)
    system = NeRFSystem(tconfig.Config(**_kw(root, tmp_path, **kw)),
                        device="cpu")
    jcfg = jconfig.Config(**_kw(root, tmp_path / "j", **kw))
    jds = JLLFF(root, split="train", img_wh=SMALL,
                spheric_poses=kw["spheric_poses"])
    np.testing.assert_array_equal(system.rays.numpy(), jds.all_rays)
    assert system.white_back is False
    with torch.no_grad():
        for m in system.models.values():
            m.sigma.w.mul_(10.0)
    params = _params(system)
    sl = slice(100, 132)
    rays, rgbs = system.rays[sl].numpy(), system.rgbs[sl].numpy()
    ov = _draws(5, 32, 8, True)
    rkw = dict(jrender_kwargs(jcfg, False, train=True), mode="rgb",
               overrides={k: jnp.asarray(v) for k, v in ov.items()})

    def loss_fn(p):
        res = jrender(p["coarse"], p["fine"], jnp.asarray(rays), None, **rkw)
        return (jmse(res, jnp.asarray(rgbs)),
                jpsnr(res["rgb_fine"], jnp.asarray(rgbs)))

    (loss_j, psnr_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    loss, psnr = system.train_step(torch.from_numpy(rays),
                                   torch.from_numpy(rgbs), torch_ov(ov))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(psnr), float(psnr_j), rtol=1e-5)
    assert_grads_match(system, grads_j, max_rel=1e-4, mean_rel=1e-5,
                       min_tensors=24)
    system.logger.close()


def _argv(root, tmp, *extra):
    return ["--root_dir", root, "--dataset_name", "llff",
            "--img_wh", *map(str, SMALL), "--N_samples", "8",
            "--N_importance", "8", "--batch_size", "64", "--num_epochs", "2",
            "--chunk", "128", "--lr", "5e-3", "--exp_name", "cli",
            "--arch_width", str(NARROW), "--optimizer", "adam",
            "--lr_scheduler", "steplr", "--decay_step", "1", "--decay_gamma",
            "0.5", "--log_dir", str(tmp / "logs"),
            "--ckpt_dir", str(tmp / "ckpts"), *extra]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cli_trains_llff_and_jax_resumes_it(scenes, tmp_path, capsys, layout):
    root = scenes[layout][1]
    extra = ["--spheric_poses"] if layout == "ring" else []
    system = train_main(_argv(root, tmp_path, *extra, "--device", "cpu"))
    out = capsys.readouterr().out
    assert "[sanity]" in out and "epoch 1: loss" in out and "val loss" in out
    # 4 training views of 16x12, batch 64
    assert system.steps_per_epoch == 4 * 16 * 12 // 64
    with open(tmp_path / "logs" / "cli" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    epochs = [r for r in recs if "train/loss" in r]
    assert len(epochs) == 2 and all(np.isfinite(r["train/loss"]) for r in epochs)
    assert epochs[1]["lr"] == pytest.approx(2.5e-3, rel=1e-6)
    path = str(tmp_path / "ckpts" / "cli" / "epoch=1.ckpt")
    raw = jckpt.load_checkpoint(path)
    np.testing.assert_array_equal(
        np.asarray(raw["params"]["fine"]["xyz_layers"]["3"]["w"]),
        nerf_to_numpy(system.models["fine"])["xyz_layers"][3]["w"])
    js = JNeRFSystem(jconfig.Config(**_kw(
        root, tmp_path / "resume", ckpt_path=path, batch_size=64, lr=5e-3,
        spheric_poses=layout == "ring")))
    assert js.epoch0 == 2
    assert int(np.asarray(js.opt_state[0].count).reshape(())) == \
        2 * system.steps_per_epoch


def test_eval_renders_the_spiral_and_the_training_poses(scenes, tmp_path, capsys):
    """``--split test``: the 120-pose spiral, PNGs, depth and a 120-frame
    GIF, no PSNR (no ground truth); ``--split test_train``: the training
    poses, against the JAX tool's renders (neither prints a PSNR: the
    loader gives those poses no ground truth, as the reference's)."""
    from test_torch_port_eval import _read_gif
    from test_torch_port_models import np_nerf

    root = scenes["fan"][1]
    params = {"coarse": np_nerf(80, W=NARROW), "fine": np_nerf(81, W=NARROW)}
    for tree in params.values():
        tree["sigma"]["w"] *= 20.0
    ckpt = str(tmp_path / "epoch=0.ckpt")
    jckpt.save_checkpoint(ckpt, {"params": params, "opt_state": [], "epoch": 0})

    def argv(out, split, wh, *extra):
        return ["--root_dir", root, "--dataset_name", "llff", "--ckpt_path",
                ckpt, "--img_wh", *map(str, wh), "--N_samples", "4",
                "--N_importance", "4", "--chunk", "4096", "--split", split,
                "--out_dir", str(out), *extra]

    assert eval_main(argv(tmp_path / "port", "test", (4, 3), "--device",
                          "cpu")) is None
    assert "Mean PSNR" not in capsys.readouterr().out
    spiral = tmp_path / "port" / "llff" / "test"
    frames, _, _ = _read_gif(spiral / "test.gif")
    assert len(frames) == 120
    assert len([n for n in os.listdir(spiral) if n.endswith(".png")]) == 120

    assert jeval.run(jeval.get_opts(argv(tmp_path / "jax", "test_train",
                                         SMALL, "--save_depth"))) is None
    assert eval_main(argv(tmp_path / "port2", "test_train", SMALL,
                          "--save_depth", "--device", "cpu")) is None
    assert "Mean PSNR" not in capsys.readouterr().out
    mine = tmp_path / "port2" / "llff" / "test"
    ref = tmp_path / "jax" / "llff" / "test"
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(mine)) == names and len(names) == 2 * VIEWS + 1
    for name in names:
        if name.endswith(".png"):
            a, _ = png.read_png(str(mine / name))
            b = np.asarray(Image.open(ref / name))
            assert a.shape == b.shape == (12, 16, 3)
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name


# ------------------------------------------------------- ops and metrics
@pytest.mark.parametrize("det", [True, False], ids=["det", "u"])
def test_sample_pdf_bins_matches_jax(det):
    rng = np.random.RandomState(9)
    weights = rng.uniform(0, 1, (64, 15)).astype(np.float32)
    weights[:8] = 0.0  # rows of eps only
    bins = np.sort(rng.uniform(2, 6, (64, 16)), axis=1).astype(np.float32)
    u = None if det else rng.uniform(size=(64, 24)).astype(np.float32)
    want = jsample_pdf_bins(jnp.asarray(bins), jnp.asarray(weights), 24,
                            det=det, u=None if u is None else jnp.asarray(u))
    got = sample_pdf_bins(torch.from_numpy(bins), torch.from_numpy(weights),
                          24, det=det,
                          u=None if u is None else torch.from_numpy(u))
    assert got.shape == (64, 24) and got.dtype == torch.float32
    # the f32 cumsum runs in another order, and (u - cdf) / (a small CDF
    # step) magnifies its ulp: 1.3e-6 relative at worst on this CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=4e-6,
                               atol=0)
    with pytest.raises(ValueError, match="generator"):
        sample_pdf_bins(torch.from_numpy(bins), torch.from_numpy(weights), 4)


def test_ssim_matches_jax():
    rng = np.random.RandomState(11)
    gt = rng.uniform(size=(1, 3, 20, 17)).astype(np.float32)
    for pred in (gt, np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1),
                 1.0 - gt):
        pred = pred.astype(np.float32)
        want = float(jmetrics.ssim(jnp.asarray(pred), jnp.asarray(gt)))
        got = metrics.ssim(torch.from_numpy(pred), torch.from_numpy(gt))
        # f32 convolutions summed in another order
        assert abs(float(got) - want) <= 1e-6, (float(got), want)
    assert float(metrics.ssim(torch.from_numpy(gt), torch.from_numpy(gt))) \
        == pytest.approx(1.0, abs=1e-6)
