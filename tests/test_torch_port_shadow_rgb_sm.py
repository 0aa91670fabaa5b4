"""The port's ``RGBSMSystem`` (joint RGB + shadow trainer) against the JAX
package's on the CPU: one training step with injected random draws, a
two-epoch deterministic trajectory and the CLI.  Also the grad comparison
the other shadow trainers' tests share.

The full-width case takes the fused MLP's plain versions (kernels D, E and
A on a card), rgb mode for the camera and sigma-only for the light; the
narrow cases take posenc + NeRF; the JAX system off the TPU takes posenc +
NeRF.  All float32, so the two differ by the order of the sums only.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu import config as jconfig
from nerf_pl_tpu.ops.rendering import render_rays as jrender
from nerf_pl_tpu.ops.shadow_mapping import efficient_sm as jefficient_sm
from nerf_pl_tpu.training import checkpoints as jckpt
from nerf_pl_tpu.training import shadow_systems as jss
from nerf_pl_tpu.training.losses import mse_loss as jmse
from nerf_pl_tpu.training.losses import sm_loss as jsm_loss
from nerf_pl_tpu.training.metrics import psnr as jpsnr
from nerf_pl_tpu_torch import config as tconfig
from nerf_pl_tpu_torch.data import synthetic
from nerf_pl_tpu_torch.models.nerf import nerf_to_numpy
from nerf_pl_tpu_torch.train_rgb_sm_juntos import main as rgb_sm_main
from nerf_pl_tpu_torch.training import checkpoints as tckpt
from nerf_pl_tpu_torch.training.shadow_systems import RGBSMSystem
from test_torch_port_shadow_train import _draws, _leaf, _params

WH, N_S, N_I = 8, 8, 8
HW = WH * WH
NARROW = 32
RGB_W, SM_W = 0.7, 1.3  # not 1: the weights must reach the loss


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rgb_sm_scene"))
    # 3 train views of 8x8: 192 rays; the light view is 64 rays
    return synthetic.generate_scene(root, img_wh=WH, n_train=3, n_val=1,
                                    n_test=1)


def _kw(root, tmp, **kw):
    base = dict(root_dir=root, dataset_name="rgb_sm", img_wh=(WH, WH),
                N_samples=N_S, N_importance=N_I, batch_size=32, num_epochs=2,
                chunk=128, lr=5e-4, noise_std=0.0, exp_name="t",
                log_dir=str(tmp / "logs"), ckpt_dir=str(tmp / "ckpts"),
                num_sanity_val_steps=0, Light_N_importance=8,
                sample_light_depth_every=2, shadow_method="shadow_method_2",
                rgb_weight=RGB_W, sm_weight=SM_W, num_devices=1)
    base.update(kw)
    return base


def _port(root, tmp, sigma_scale=10.0, **kw):
    """The port's system on the CPU; the sigma heads scaled so the random
    scene is partly opaque and its depths vary."""
    system = RGBSMSystem(tconfig.Config(**_kw(root, tmp, **kw)), device="cpu")
    with torch.no_grad():
        for m in system.models.values():
            m.sigma.w.mul_(sigma_scale)
    return system


def assert_grads_match(system, grads_j, max_rel=5e-3, mean_rel=1e-4,
                       min_tensors=12, exclude=()):
    """Every parameter grad of the port's step (but the ``exclude`` names)
    within ``max_rel`` of the JAX tensor's largest grad, and within
    ``mean_rel`` of it on average over a tensor of 64 values or more.
    Returns the worst readings."""
    worst, n_grads = (0.0, 0.0), 0
    for name, model in system.models.items():
        for pname, p in model.named_parameters():
            if pname in exclude:
                continue
            ref = _leaf(grads_j[name], pname)
            # a sigma-only render leaves the direction head out: no grad in
            # posenc + NeRF, zeros in JAX and the fused route
            got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
            scale = np.abs(ref).max()
            if scale == 0:
                assert np.abs(got).max() == 0, (name, pname)
                continue
            d = np.abs(got - ref) / scale
            assert d.max() <= max_rel, (name, pname, d.max())
            if d.size >= 64:
                assert d.mean() <= mean_rel, (name, pname, d.mean())
            worst = (max(worst[0], d.max()),
                     max(worst[1], d.mean() if d.size >= 64 else 0.0))
            n_grads += 1
    assert n_grads >= min_tensors
    return worst


def jax_rkw(jcfg, n_importance, ov, **kw):
    """The JAX renderer's keywords for a render of a training step, with the
    injected draws."""
    return dict(jss._sigma_render_kwargs(jcfg, n_importance), **kw,
                overrides={k: jnp.asarray(v) for k, v in ov.items()})


def torch_ov(ov):
    return {k: torch.from_numpy(v) for k, v in ov.items()}


# ------------------------------------------------------------ one step
@pytest.mark.parametrize("grad_on_light,width", [(True, 256), (True, NARROW),
                                                 (False, NARROW)],
                         ids=["gol-full", "gol-narrow", "cache-narrow"])
def test_one_step_matches_a_jax_step(scene, tmp_path, grad_on_light, width):
    light_n = 8
    kw = dict(grad_on_light=grad_on_light, perturb=1.0, noise_std=1.0,
              arch_width=width)
    system = _port(scene, tmp_path, **kw)
    jcfg = jconfig.Config(**_kw(scene, tmp_path, **kw))
    params = _params(system)
    B, sl = 32, slice(48, 80)  # the batch spans two poses
    ov_cam, ov_light = _draws(1, B, N_I, True), _draws(2, HW, light_n, True)
    rays, rgbs, sms, pixels, pidx = (getattr(system, k)[sl].numpy() for k in
                                     system.train_bufs)
    assert len(set(pidx.tolist())) == 2 and not np.array_equal(rgbs, sms)
    tables = {k: jnp.asarray(getattr(system, k).numpy()) for k in (
        "cam_ms", "cam_eyes", "light_rays", "light_pixels", "light_m", "light_eye")}

    rkw_cam = jax_rkw(jcfg, N_I, ov_cam, mode="rgb_disp", white_back=True)
    rkw_cam.pop("remat_fine")
    rkw_light = jax_rkw(jcfg, light_n, ov_light)
    cache_j = jss._light_cache_render(params, tables["light_rays"], None,
                                      rkw_light)

    def loss_fn(p):
        cam = jrender(p["coarse"], p["fine"], jnp.asarray(rays), None, **rkw_cam)
        light = (jss._light_cache_render(p, tables["light_rays"], None,
                                         rkw_light)
                 if grad_on_light else cache_j)
        out = jefficient_sm(
            jnp.asarray(pixels), tables["light_pixels"], cam, light,
            tables["cam_ms"][pidx], tables["cam_eyes"][pidx],
            tables["light_m"], tables["light_eye"], (WH, WH),
            fine_sampling=True, light_has_fine=True,
            shadow_method="shadow_method_2", pose_idx=jnp.asarray(pidx),
            num_poses=3, out_prefix="sm")
        loss = RGB_W * jmse(out, jnp.asarray(rgbs)) + SM_W * jsm_loss(out, jnp.asarray(sms))
        return loss, (jpsnr(out["rgb_fine"], jnp.asarray(rgbs)),
                      jpsnr(out["sm_fine"], jnp.asarray(sms)))

    (loss_j, (psnr_j, sm_psnr_j)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, params))
    with torch.no_grad():
        cache_t = system.light_render(light_n, torch_ov(ov_light))
    loss, psnr, sm_psnr = system.train_step(
        *(torch.from_numpy(a) for a in (rays, rgbs, sms, pixels, pidx)),
        cache_t, light_n,
        overrides={"cam": torch_ov(ov_cam), "light": torch_ov(ov_light)})
    # f32 through both pipelines: the order of the sums only
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(psnr), float(psnr_j), rtol=1e-5)
    np.testing.assert_allclose(float(sm_psnr), float(sm_psnr_j), rtol=1e-5)
    # the rgb camera pass differentiates the direction head too; the
    # tolerances and their reasons are the flagship shadow step's
    # (test_torch_port_shadow_train.py): the light's far samples and the
    # fine samples' bins.  Worst on the CPU: 8.1e-4 max, 5.0e-6 mean (full
    # width); 6.1e-5 and 1.4e-6 narrow
    assert_grads_match(system, grads_j, min_tensors=30)


# ----------------------------------------------------- two-epoch trajectory
def test_two_epoch_trajectory_matches_jax(scene, tmp_path):
    """perturb 0, noise 0, the light cache refreshed every 2 of an epoch's 3
    steps: both packages are deterministic."""
    kw = dict(perturb=0.0, noise_std=0.0, batch_size=64, lr=1e-5,
              arch_width=NARROW)
    system = _port(scene, tmp_path / "t", **kw)
    start = str(tmp_path / "start.ckpt")
    tckpt.save_checkpoint(start, {"params": system.models})
    js = jss.RGBSMSystem(jconfig.Config(**_kw(scene, tmp_path / "j",
                                              ckpt_path=start, **kw)))
    assert js.mesh.devices.size == 1 and js.steps_per_epoch == 3
    losses_j, sm_psnrs_j, gstep = [], [], 0
    for epoch in range(2):
        cache = js._init_light_cache()
        js.rng, ek = jax.random.split(js.rng)
        fn = js._epoch_fn_for(js._resolve_light_n(epoch), None)
        js.params, js.opt_state, cache, lk, _, sk = fn(
            js.params, js.opt_state, cache, js.rays_buf, js.rgbs_buf,
            js.sm_buf, js.pixels_buf, js.pose_idx_buf, js.light_rays_in,
            js._tables(), ek, jnp.int32(gstep), jnp.int32(0))
        losses_j.extend(np.asarray(lk).tolist())
        sm_psnrs_j.extend(np.asarray(sk).tolist())
        gstep += js.steps_per_epoch
    losses, sm_psnrs, gstep = [], [], 0
    for epoch in range(2):
        m = system.train_epoch(epoch, gstep)
        losses.extend(m["train/loss"].tolist())
        sm_psnrs.extend(m["train/sm_psnr"].tolist())
        gstep += system.steps_per_epoch
    assert len(losses) == len(losses_j) == 6
    # the flagship trainer's trajectory tolerances (the shadow map is discontinuous in the
    # weights: test_torch_port_shadow_train.py).  Worst on the CPU: the
    # losses 2.1e-4 relative, sm_psnr 1.0e-4; the weights 6.6e-5 apart at
    # most, 98.1% of them within 2e-6
    np.testing.assert_allclose(losses, losses_j, rtol=2e-2)
    np.testing.assert_allclose(sm_psnrs, sm_psnrs_j, rtol=2e-2)
    got = np.concatenate([a.ravel() for name in ("coarse", "fine") for a in
                          jax.tree_util.tree_leaves(nerf_to_numpy(system.models[name]))])
    want = np.concatenate([np.asarray(b).ravel() for name in ("coarse", "fine")
                           for b in jax.tree_util.tree_leaves(js.params[name])])
    d = np.abs(got - want)
    assert d.max() <= 6 * 2 * 1e-5, d.max()
    assert (d <= 2e-6).mean() >= 0.95, (d <= 2e-6).mean()


def test_the_loader_must_have_shadow_targets(scene, tmp_path):
    with pytest.raises(ValueError, match="ROADMAP"):  # not a shadow loader
        _port(scene, tmp_path, dataset_name="shadows", arch_width=NARROW)
    with pytest.raises(KeyError, match="all_sm"):
        _port(scene, tmp_path, dataset_name="efficient_sm", arch_width=NARROW)


# -------------------------------------------------------------------- CLI
def _argv(root, tmp, *extra):
    return ["--root_dir", root, "--dataset_name", "rgb_sm",
            "--img_wh", str(WH), str(WH), "--N_samples", "8",
            "--N_importance", "8", "--batch_size", "64", "--num_epochs", "2",
            "--chunk", "128", "--lr", "5e-4", "--noise_std", "0",
            "--Light_N_importance", "8", "--blur", "2",
            "--shadow_method", "shadow_method_2", "--exp_name", "cli",
            "--arch_width", str(NARROW),
            "--log_dir", str(tmp / "logs"), "--ckpt_dir", str(tmp / "ckpts"),
            *extra]


def test_cli_trains_and_writes_checkpoints_jax_loads(scene, tmp_path, capsys):
    system = rgb_sm_main(_argv(scene, tmp_path, "--device", "cpu"))
    out = capsys.readouterr().out
    assert "[sanity]" in out and "epoch 1: loss" in out and "sm_psnr" in out
    assert system.train_dataset.blur == 2
    with open(tmp_path / "logs" / "cli" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    epochs = [r for r in recs if "train/loss" in r]
    assert len(epochs) == 2
    for r in epochs:
        for k in ("train/loss", "train/psnr", "train/sm_psnr", "lr",
                  "train/rays_per_s"):
            assert np.isfinite(r[k]), k
    vals = [r for r in recs if "val/loss" in r]
    assert len(vals) == 2 and all(np.isfinite(r["val/sm_psnr"]) for r in vals)
    assert os.path.exists(tmp_path / "logs" / "cli" / "imgs" / "disp_001.png")
    path = str(tmp_path / "ckpts" / "cli" / "epoch=1.ckpt")
    raw = jckpt.load_checkpoint(path)
    np.testing.assert_array_equal(
        np.asarray(raw["params"]["fine"]["rgb"]["w"]),
        nerf_to_numpy(system.models["fine"])["rgb"]["w"])
    js = jss.RGBSMSystem(jconfig.Config(**_kw(
        scene, tmp_path / "resume", ckpt_path=path, batch_size=64,
        arch_width=NARROW)))
    assert js.epoch0 == 2
    count = np.asarray(js.opt_state[0].count)
    assert int(count.reshape(())) == 2 * system.steps_per_epoch


def test_cli_defaults_to_cuda(scene, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rgb_sm_main(_argv(scene, tmp_path))
