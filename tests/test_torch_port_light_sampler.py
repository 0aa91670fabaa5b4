"""The port's ``LightSamplerSystem`` (the sampled-light shadow trainer)
against the JAX package's on the CPU: one training step with injected
random draws (the chosen light pixels first, then the loss and every grad),
the projection and composite helpers of its validation, and the CLI."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu import config as jconfig
from nerf_pl_tpu.ops.rendering import render_rays as jrender
from nerf_pl_tpu.ops.shadow_mapping import generate_shadow_map as jgenerate
from nerf_pl_tpu.ops.shadow_mapping import get_normed_w as jnormed_w
from nerf_pl_tpu.ops.shadow_mapping import get_projections as jprojections
from nerf_pl_tpu.training import checkpoints as jckpt
from nerf_pl_tpu.training import shadow_systems as jss
from nerf_pl_tpu.training.metrics import psnr as jpsnr
from nerf_pl_tpu_torch import config as tconfig
from nerf_pl_tpu_torch.data import synthetic
from nerf_pl_tpu_torch.models.nerf import nerf_to_numpy
from nerf_pl_tpu_torch.ops.rendering import render_rays
from nerf_pl_tpu_torch.train_light_sampler import main as ls_main
from nerf_pl_tpu_torch.training.shadow_systems import (LightSamplerSystem,
                                                       ls_composite, ls_project)
from test_torch_port_shadow_rgb_sm import assert_grads_match, jax_rkw, torch_ov
from test_torch_port_shadow_train import _draws, _params

WH, N_S, N_I = 8, 8, 8
NARROW = 32


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ls_scene"))
    return synthetic.generate_scene(root, img_wh=WH, n_train=3, n_val=1,
                                    n_test=1)


def _kw(root, tmp, **kw):
    base = dict(root_dir=root, dataset_name="efficient_sm", img_wh=(WH, WH),
                N_samples=N_S, N_importance=N_I, batch_size=32, num_epochs=2,
                chunk=128, lr=5e-4, noise_std=0.0, exp_name="t",
                log_dir=str(tmp / "logs"), ckpt_dir=str(tmp / "ckpts"),
                num_sanity_val_steps=0, Light_N_importance=8,
                shadow_method="shadow_method_2", num_devices=1)
    base.update(kw)
    return base


def _port(root, tmp, sigma_scale=10.0, **kw):
    system = LightSamplerSystem(tconfig.Config(**_kw(root, tmp, **kw)),
                                device="cpu")
    with torch.no_grad():
        for m in system.models.values():
            m.sigma.w.mul_(sigma_scale)
    return system


def _geom_j(system):
    """The JAX system's light geometry, as ``_light_geom`` gives it."""
    light = system.train_dataset.light
    return (jnp.asarray(light.l2w), jnp.float32(light.focal),
            jnp.float32(light.near), jnp.float32(light.far))


@pytest.mark.parametrize("light_n,width", [(8, 256), (8, NARROW), (0, NARROW)],
                         ids=["ln8-full", "ln8-narrow", "ln0-narrow"])
def test_one_step_matches_a_jax_step(scene, tmp_path, light_n, width):
    kw = dict(Light_N_importance=light_n, perturb=1.0, noise_std=1.0,
              arch_width=width)
    system = _port(scene, tmp_path, **kw)
    jcfg = jconfig.Config(**_kw(scene, tmp_path, **kw))
    params = _params(system)
    B, sl = 32, slice(48, 80)  # the batch spans two poses
    ov_cam, ov_light = _draws(1, B, N_I, True), _draws(2, B, light_n, True)
    rays, rgbs, pixels, pidx = (getattr(system, k)[sl].numpy() for k in
                                ("rays", "rgbs", "pixels", "pose_idx"))
    assert len(set(pidx.tolist())) == 2
    cam_ms, cam_eyes, light_m, light_eye = (
        jnp.asarray(getattr(system, k).numpy()) for k in
        ("cam_ms", "cam_eyes", "light_m", "light_eye"))
    rkw_cam = jax_rkw(jcfg, N_I, ov_cam)
    rkw_light = jax_rkw(jcfg, light_n, ov_light)
    geom = _geom_j(system)

    def project(p):
        """The JAX step's projection (shadow_systems.py:1059-1072)."""
        cam = jrender(p["coarse"], p["fine"], jnp.asarray(rays), None, **rkw_cam)
        pd_cam = jnp.concatenate([jnp.asarray(pixels),
                                  cam["depth_fine"][:, None]], axis=1)
        K = jprojections(cam_ms[pidx], cam_eyes[pidx], light_m, light_eye,
                         pd_cam)
        ul = jnp.floor(jnp.clip(K[:, 0], 0.0, WH - 1.0))
        vl = jnp.floor(jnp.clip(K[:, 1], 0.0, WH - 1.0))
        return K, ul, vl, jss._light_rays_from_uv_fn(ul, vl, (WH, WH), *geom)

    def loss_fn(p):
        """The rest of the JAX step (shadow_systems.py:1073-1094)."""
        K, ul, vl, lrays = project(p)
        light = jrender(p["coarse"], p["fine"], jax.lax.stop_gradient(lrays),
                        None, **rkw_light)
        depth = light["depth_fine"] if light_n > 0 else light["depth_coarse"]
        lpix = jnp.stack([ul + 0.5, vl + 0.5, jnp.ones_like(ul)], axis=1)
        w_light = jnormed_w(light_m, jnp.concatenate([lpix, depth[:, None]], 1))
        sm = jgenerate(K[:, 2], w_light[:, 3], mode="shadow_method_2")
        return jnp.mean((sm - jnp.asarray(rgbs)) ** 2), jpsnr(sm, jnp.asarray(rgbs))

    pj = jax.tree_util.tree_map(jnp.asarray, params)
    K_j, ul_j, vl_j, lrays_j = project(pj)
    # the chosen light pixels first: a floor at a pixel's edge would flip
    # them if the projections differed by an ulp there
    with torch.no_grad():
        cam = render_rays(system.models["coarse"], system.models["fine"],
                          torch.from_numpy(rays), None, overrides=torch_ov(ov_cam),
                          **system.rkw)
        K, ul, vl, lrays = ls_project(
            cam, torch.from_numpy(pixels), system.cam_ms[pidx],
            system.cam_eyes[pidx], system.light_m, system.light_eye,
            *system.light_geom, (WH, WH), True)
    np.testing.assert_array_equal(ul.numpy(), np.asarray(ul_j))
    np.testing.assert_array_equal(vl.numpy(), np.asarray(vl_j))
    # the batch reaches more than one light pixel, not only the view's edge
    assert len(set(zip(ul.tolist(), vl.tolist()))) >= 4
    # and not by luck: the projections lie farther from a pixel's edge than
    # the two packages' projections lie apart (on the CPU: 9.4e-3 of a pixel
    # against 3.1e-5)
    Kn, Kj = K.numpy()[:, :2], np.asarray(K_j)[:, :2]
    edge = np.min(np.minimum(Kj - np.floor(Kj), np.ceil(Kj) - Kj))
    assert np.abs(Kn - Kj).max() < edge, (np.abs(Kn - Kj).max(), edge)
    np.testing.assert_allclose(K.numpy(), np.asarray(K_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lrays.numpy(), np.asarray(lrays_j), rtol=1e-6,
                               atol=1e-6)

    (loss_j, psnr_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(pj)
    loss, psnr = system.train_step(
        *(torch.from_numpy(a) for a in (rays, rgbs, pixels, pidx)),
        overrides={"cam": torch_ov(ov_cam), "light": torch_ov(ov_light)})
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(psnr), float(psnr_j), rtol=1e-5)
    # with a fine light pass the loss reads only the fine depths, and the
    # coarse passes feed only the detached importance sampling: the coarse
    # model has no grad, in JAX (zeros) as in the port (its backward never
    # runs: E twice a step on the card)
    no_coarse = [np.abs(np.asarray(g)).max() == 0 for g in
                 jax.tree_util.tree_leaves(grads_j["coarse"])]
    assert all(no_coarse) == (light_n > 0)
    assert all(p.grad is None for p in system.models["coarse"].parameters()) \
        == (light_n > 0)
    # the flagship shadow step's tolerances (test_torch_port_shadow_train.py).
    # Worst on the CPU: 6.5e-5 max, 2.3e-6 mean (full width); 9.1e-5 and
    # 4.4e-6 narrow
    assert_grads_match(system, grads_j, min_tensors=12)


def test_validation_helpers_match_jax(scene, tmp_path):
    """``ls_project`` and ``ls_composite`` on a whole val frame against the
    JAX validation's ``_ls_project`` and ``_ls_composite``."""
    system = _port(scene, tmp_path, arch_width=NARROW)
    sample = system.val_dataset[0]
    rng = np.random.RandomState(3)
    depth = {"depth_coarse": rng.uniform(2, 9, WH * WH).astype(np.float32),
             "depth_fine": rng.uniform(2, 9, WH * WH).astype(np.float32)}
    light_depth = rng.uniform(2, 9, WH * WH).astype(np.float32)
    light = system.train_dataset.light
    for fine in (False, True):
        K_j, ul_j, vl_j, lrays_j = jss._ls_project(
            {k: jnp.asarray(v) for k, v in depth.items()},
            jnp.asarray(sample["pixels"]), jnp.asarray(sample["ppc"]["camera"]),
            jnp.asarray(sample["ppc"]["eye_pos"]), jnp.asarray(light.camera),
            jnp.asarray(light.eye_pos), *_geom_j(system), wh=(WH, WH),
            fine=fine)
        K, ul, vl, lrays = ls_project(
            {k: torch.from_numpy(v) for k, v in depth.items()},
            torch.from_numpy(sample["pixels"]),
            torch.from_numpy(sample["ppc"]["camera"]),
            torch.from_numpy(sample["ppc"]["eye_pos"]), system.light_m,
            system.light_eye, *system.light_geom, (WH, WH), fine)
        np.testing.assert_array_equal(ul.numpy(), np.asarray(ul_j))
        np.testing.assert_array_equal(vl.numpy(), np.asarray(vl_j))
        np.testing.assert_allclose(lrays.numpy(), np.asarray(lrays_j),
                                   rtol=1e-6, atol=1e-6)
        sm_j = jss._ls_composite(K_j, ul_j, vl_j, jnp.asarray(light_depth),
                                 jnp.asarray(light.camera),
                                 mode="shadow_method_2")
        sm = ls_composite(K, ul, vl, torch.from_numpy(light_depth),
                          system.light_m, "shadow_method_2")
        np.testing.assert_allclose(sm.numpy(), np.asarray(sm_j), rtol=1e-5,
                                   atol=1e-6)


# -------------------------------------------------------------------- CLI
def _argv(root, tmp, *extra):
    return ["--root_dir", root, "--dataset_name", "efficient_sm",
            "--img_wh", str(WH), str(WH), "--N_samples", "8",
            "--N_importance", "8", "--batch_size", "64", "--num_epochs", "2",
            "--chunk", "128", "--lr", "5e-4", "--noise_std", "0",
            "--Light_N_importance", "8", "--shadow_method", "shadow_method_2",
            "--exp_name", "cli", "--arch_width", str(NARROW),
            "--log_dir", str(tmp / "logs"), "--ckpt_dir", str(tmp / "ckpts"),
            *extra]


def test_cli_trains_and_writes_checkpoints_jax_loads(scene, tmp_path, capsys):
    system = ls_main(_argv(scene, tmp_path, "--device", "cpu"))
    out = capsys.readouterr().out
    assert "[sanity]" in out and "epoch 1: loss" in out
    with open(tmp_path / "logs" / "cli" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    epochs = [r for r in recs if "train/loss" in r]
    assert len(epochs) == 2 and all(np.isfinite(r["train/loss"]) for r in epochs)
    assert sum("val/loss" in r for r in recs) == 2
    assert (tmp_path / "logs" / "cli" / "imgs" / "rgb_001.png").exists()
    path = str(tmp_path / "ckpts" / "cli" / "epoch=1.ckpt")
    raw = jckpt.load_checkpoint(path)
    np.testing.assert_array_equal(
        np.asarray(raw["params"]["coarse"]["sigma"]["w"]),
        nerf_to_numpy(system.models["coarse"])["sigma"]["w"])
    js = jss.LightSamplerSystem(jconfig.Config(**_kw(
        scene, tmp_path / "resume", ckpt_path=path, batch_size=64,
        arch_width=NARROW)))
    assert js.epoch0 == 2
    count = np.asarray(js.opt_state[0].count)
    assert int(count.reshape(())) == 2 * system.steps_per_epoch


def test_cli_defaults_to_cuda_and_rejects_other_loaders(scene, tmp_path,
                                                        monkeypatch):
    with pytest.raises(ValueError, match="ROADMAP"):
        ls_main(_argv(scene, tmp_path, "--dataset_name", "shadows",
                      "--device", "cpu"))
    with pytest.raises(ValueError, match="shuffle=False"):
        ls_main(_argv(scene, tmp_path, "--global_reshuffle", "--device", "cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ls_main(_argv(scene, tmp_path))
