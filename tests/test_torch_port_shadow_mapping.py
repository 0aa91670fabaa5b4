"""The port's ``ShadowMappingSystem`` (the image-space shadow trainer)
against the JAX package's on the CPU: one training step over whole images
with injected random draws, the image order of an epoch, the checkpoints
of every epoch, SIGTERM and the CLI."""
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu import config as jconfig
from nerf_pl_tpu.ops.rendering import render_rays as jrender
from nerf_pl_tpu.ops.shadow_mapping import \
    shadow_mapping_images as jshadow_mapping_images
from nerf_pl_tpu.training import checkpoints as jckpt
from nerf_pl_tpu.training import shadow_systems as jss
from nerf_pl_tpu.training.losses import mse_loss as jmse
from nerf_pl_tpu.training.metrics import psnr as jpsnr
from nerf_pl_tpu_torch import config as tconfig
from nerf_pl_tpu_torch.data import synthetic
from nerf_pl_tpu_torch.models.nerf import nerf_to_numpy
from nerf_pl_tpu_torch.train_shadow_mapping import main as smap_main
from nerf_pl_tpu_torch.training.shadow_systems import ShadowMappingSystem
from test_torch_port_shadow_rgb_sm import assert_grads_match, jax_rkw, torch_ov
from test_torch_port_shadow_train import _draws, _params

WH, N_S, N_I = 8, 8, 8
HW = WH * WH
NARROW = 32


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("smap_scene"))
    return synthetic.generate_scene(root, img_wh=WH, n_train=3, n_val=1,
                                    n_test=1)


def _kw(root, tmp, **kw):
    base = dict(root_dir=root, dataset_name="shadows", img_wh=(WH, WH),
                N_samples=N_S, N_importance=N_I, batch_size=2, num_epochs=2,
                chunk=128, lr=5e-4, noise_std=0.0, exp_name="t",
                log_dir=str(tmp / "logs"), ckpt_dir=str(tmp / "ckpts"),
                num_sanity_val_steps=0, shadow_method="shadow_method_2",
                num_devices=1)
    base.update(kw)
    return base


def _port(root, tmp, sigma_scale=10.0, **kw):
    system = ShadowMappingSystem(tconfig.Config(**_kw(root, tmp, **kw)),
                                 device="cpu")
    with torch.no_grad():
        for m in system.models.values():
            m.sigma.w.mul_(sigma_scale)
    return system


@pytest.mark.parametrize("images,width", [(2, 256), (2, NARROW), (1, NARROW)],
                         ids=["2img-full", "2img-narrow", "1img-narrow"])
def test_one_step_matches_a_jax_step(scene, tmp_path, images, width):
    kw = dict(perturb=1.0, noise_std=1.0, batch_size=images, arch_width=width)
    system = _port(scene, tmp_path, **kw)
    jcfg = jconfig.Config(**_kw(scene, tmp_path, **kw))
    params = _params(system)
    idx = [1, 2][:images]
    ov_cam = _draws(1, images * HW, N_I, True)
    ov_light = _draws(2, HW, N_I, True)
    rays, rgbs, cam_ms, cam_eyes = (getattr(system, k)[idx].numpy() for k in
                                    ("rays", "rgbs", "cam_ms", "cam_eyes"))
    light_rays, light_m, light_eye = (
        jnp.asarray(getattr(system, k).numpy()) for k in
        ("light_rays", "light_m", "light_eye"))
    # the shadows loader's light samples out to 500
    assert float(light_rays[0, 7]) == 500.0
    rkw_cam = jax_rkw(jcfg, N_I, ov_cam)
    rkw_light = jax_rkw(jcfg, N_I, ov_light)

    def loss_fn(p):
        """The JAX step on one device (shadow_systems.py:1367-1397)."""
        cam = jrender(p["coarse"], p["fine"], jnp.asarray(rays.reshape(-1, 8)),
                      None, **rkw_cam)
        light = jrender(p["coarse"], p["fine"], light_rays, None, **rkw_light)
        out = jshadow_mapping_images(
            {k: v for k, v in cam.items() if k.startswith("depth")},
            {k: jnp.tile(v, (images,)) for k, v in light.items()
             if k.startswith("depth")},
            jnp.asarray(cam_ms), jnp.asarray(cam_eyes), light_m, light_eye,
            (WH, WH), images, fine_sampling=True,
            shadow_method="shadow_method_2")
        targets = jnp.asarray(rgbs.reshape(-1, 3))
        return jmse(out, targets), jpsnr(out["rgb_fine"], targets)

    (loss_j, psnr_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    loss, psnr = system.train_step(
        *(torch.from_numpy(a) for a in (rays, rgbs, cam_ms, cam_eyes)),
        overrides={"cam": torch_ov(ov_cam), "light": torch_ov(ov_light)})
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(psnr), float(psnr_j), rtol=1e-5)
    # the flagship shadow step's tolerances (test_torch_port_shadow_train.py)
    # hold at this light's far plane of 500 too: its samples reach |x| ~ 490,
    # where one ulp (3.1e-5) moves the 2^9-frequency encoding by 1.6e-2 rad,
    # 4x the efficient_sm light's at 200.  Worst on the CPU: 3.8e-5 max,
    # 3.8e-6 mean (full width); 9.0e-5 and 1.2e-6 narrow
    assert_grads_match(system, grads_j, min_tensors=12)


def test_epoch_steps_images_in_order(scene, tmp_path):
    """``(s * B + k) % n``: 3 images, 4 a step, one step an epoch."""
    system = _port(scene, tmp_path, batch_size=4, arch_width=NARROW)
    assert system.steps_per_epoch == 1
    assert system.rays_per_step == 4 * HW
    seen, real = [], system.train_step

    def spy(rays, rgbs, cam_ms, cam_eyes, overrides=None):
        seen.append([int(torch.nonzero((system.cam_ms == m).all(-1).all(-1))[0])
                     for m in cam_ms])
        return real(rays, rgbs, cam_ms, cam_eyes, overrides)

    system.train_step = spy
    system.train_epoch(0, 0)
    assert seen == [[0, 1, 2, 0]]
    system = _port(scene, tmp_path, batch_size=1, arch_width=NARROW)
    assert system.steps_per_epoch == 3


def _argv(root, tmp, *extra):
    return ["--root_dir", root, "--dataset_name", "shadows",
            "--img_wh", str(WH), str(WH), "--N_samples", "8",
            "--N_importance", "8", "--batch_size", "1", "--num_epochs", "2",
            "--chunk", "128", "--lr", "5e-4", "--noise_std", "0",
            "--shadow_method", "shadow_method_2", "--exp_name", "cli",
            "--arch_width", str(NARROW), "--val_every_n_epochs", "2",
            "--log_dir", str(tmp / "logs"), "--ckpt_dir", str(tmp / "ckpts"),
            *extra]


def test_cli_writes_every_epoch_and_jax_loads(scene, tmp_path, capsys):
    system = smap_main(_argv(scene, tmp_path, "--device", "cpu"))
    out = capsys.readouterr().out
    assert "[sanity]" in out and "epoch 1: loss" in out
    with open(tmp_path / "logs" / "cli" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    epochs = [r for r in recs if "train/loss" in r]
    assert len(epochs) == 2 and all(np.isfinite(r["train/loss"]) for r in epochs)
    assert sum("val/loss" in r for r in recs) == 1  # every 2nd epoch
    # epoch=N.ckpt every epoch, validated or not, and nothing else
    assert sorted(os.listdir(tmp_path / "ckpts" / "cli")) == [
        "epoch=0.ckpt", "epoch=1.ckpt"]
    for epoch in (0, 1):
        raw = jckpt.load_checkpoint(
            str(tmp_path / "ckpts" / "cli" / f"epoch={epoch}.ckpt"))
        assert int(raw["epoch"]) == epoch
        count = np.asarray(raw["opt_state"]["0"]["count"]).item()
        assert count == (epoch + 1) * system.steps_per_epoch == 3 * (epoch + 1)
    np.testing.assert_array_equal(
        np.asarray(raw["params"]["fine"]["sigma"]["w"]),
        nerf_to_numpy(system.models["fine"])["sigma"]["w"])
    # the JAX image-space trainer reads no checkpoint; its RGB trainer on the
    # same loader resumes from this one
    js = jss.ShadowsSystem(jconfig.Config(**_kw(
        scene, tmp_path / "resume", arch_width=NARROW, batch_size=64,
        ckpt_path=str(tmp_path / "ckpts" / "cli" / "epoch=1.ckpt"))))
    assert js.epoch0 == 2


def test_sigterm_saves_the_epoch_before(scene, tmp_path):
    class Stop(Exception):
        pass

    def stop(signum, frame):
        raise Stop

    system = _port(scene, tmp_path, batch_size=1, num_epochs=3,
                   arch_width=NARROW)
    real_step, n = system.train_step, {"steps": 0}

    def step(*args, **kw):
        n["steps"] += 1
        if n["steps"] == 5:  # epoch 1, its second step
            system._preempted = True
        return real_step(*args, **kw)

    system.train_step = step
    prev = signal.signal(signal.SIGTERM, stop)
    try:
        with pytest.raises(Stop):
            system.fit()
    finally:
        signal.signal(signal.SIGTERM, prev)
    saved = jckpt.load_checkpoint(str(tmp_path / "ckpts" / "t" / "preempt.ckpt"))
    assert int(saved["epoch"]) == 0
    assert np.asarray(saved["opt_state"]["0"]["count"]).item() == 5


def test_cli_rejects_and_defaults_to_cuda(scene, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="not supported by ShadowMappingSystem"):
        smap_main(_argv(scene, tmp_path, "--per_host_data", "--device", "cpu"))
    with pytest.raises(ValueError, match="shuffle=False"):
        smap_main(_argv(scene, tmp_path, "--global_reshuffle", "--device", "cpu"))
    with pytest.raises(ValueError, match="ROADMAP"):
        smap_main(_argv(scene, tmp_path, "--dataset_name", "efficient_sm",
                        "--device", "cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        smap_main(_argv(scene, tmp_path))
