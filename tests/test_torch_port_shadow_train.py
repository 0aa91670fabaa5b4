"""The port's ``EfficientSMSystem`` against the JAX package's on the CPU: one
training step with injected random draws, a two-epoch deterministic
trajectory, the control flow (light samples, cache refreshes, batch past the
light view, dispatch slices, SIGTERM) and the CLI.

The port's renders take the fused MLP's plain versions (kernels D, E, A and
B on a card); the JAX system off the TPU takes posenc + NeRF.  Both are
float32, so the two differ by the order of the sums only.
"""
import json
import os
import signal
import types

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
from nerf_pl_tpu.training.losses import opacity_loss as jopacity
from nerf_pl_tpu.training.metrics import psnr as jpsnr
from nerf_pl_tpu_torch import config as tconfig
from nerf_pl_tpu_torch.data import synthetic
from nerf_pl_tpu_torch.models.nerf import nerf_to_numpy
from nerf_pl_tpu_torch.train import main as train_main
from nerf_pl_tpu_torch.train_efficient_sm import main as sm_main
from nerf_pl_tpu_torch.training import checkpoints as tckpt
from nerf_pl_tpu_torch.training.shadow_systems import EfficientSMSystem
from nerf_pl_tpu_torch.training.trainer import NeRFSystem

WH, N_S, N_I = 8, 8, 8
HW = WH * WH
LAUNCHER_LR = 1e-5  # launchers/efficient_sm_64.sh
# The control flow does not depend on the width: the tests of it train a
# narrow MLP (posenc + NeRF; the fused route takes W = 256 only) to stay short
NARROW = 32


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shadow_scene"))
    # 3 train views of 8x8: 192 rays; the light view is 64 rays
    return synthetic.generate_scene(root, img_wh=WH, n_train=3, n_val=1,
                                    n_test=1)


def _kw(root, tmp, **kw):
    base = dict(root_dir=root, dataset_name="efficient_sm", img_wh=(WH, WH),
                N_samples=N_S, N_importance=N_I, batch_size=32, num_epochs=2,
                chunk=128, lr=5e-4, noise_std=0.0, exp_name="t",
                log_dir=str(tmp / "logs"), ckpt_dir=str(tmp / "ckpts"),
                num_sanity_val_steps=0, Light_N_importance=0,
                sample_light_depth_every=2, shadow_method="shadow_method_2",
                num_devices=1)
    base.update(kw)
    return base


def _port(root, tmp, sigma_scale=10.0, **kw):
    """The port's system on the CPU; the sigma heads scaled so the random
    scene is partly opaque and its depths vary."""
    system = EfficientSMSystem(tconfig.Config(**_kw(root, tmp, **kw)),
                               device="cpu")
    with torch.no_grad():
        for m in system.models.values():
            m.sigma.w.mul_(sigma_scale)
    return system


def _params(system):
    return {k: nerf_to_numpy(m) for k, m in system.models.items()}


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[int(k)] if k.isdigit() else tree[k]
    return np.asarray(tree, np.float32)


def _draws(seed, n, n_imp, noise):
    rng = np.random.RandomState(seed)
    ov = {"perturb_rand": rng.uniform(size=(n, N_S)).astype(np.float32)}
    if noise:
        ov["noise_coarse"] = rng.normal(size=(n, N_S)).astype(np.float32)
    if n_imp:
        ov["u"] = rng.uniform(size=(n, n_imp)).astype(np.float32)
        ov["jitter"] = rng.uniform(size=(n, n_imp)).astype(np.float32)
        if noise:
            ov["noise_fine"] = rng.normal(size=(n, N_S + n_imp)).astype(np.float32)
    return ov


# ------------------------------------------------------------ one step
@pytest.mark.parametrize("light_n", [0, 8])
@pytest.mark.parametrize("grad_on_light", [False, True], ids=["cache", "gol"])
def test_one_step_matches_a_jax_step(scene, tmp_path, grad_on_light, light_n):
    kw = dict(grad_on_light=grad_on_light, Light_N_importance=light_n,
              perturb=1.0, noise_std=1.0)
    system = _port(scene, tmp_path, **kw)
    jcfg = jconfig.Config(**_kw(scene, tmp_path, **kw))
    params = _params(system)
    B, sl = 32, slice(48, 80)  # the batch spans two poses
    ov_cam, ov_light = _draws(1, B, N_I, True), _draws(2, HW, light_n, True)
    rays, rgbs, pixels, pidx = (t[sl].numpy() for t in (
        system.rays, system.rgbs, system.pixels, system.pose_idx))
    assert len(set(pidx.tolist())) == 2
    tables = {k: getattr(system, k).numpy() for k in (
        "cam_ms", "cam_eyes", "light_rays", "light_pixels", "light_m", "light_eye")}

    rkw_cam = dict(jss._sigma_render_kwargs(jcfg, N_I),
                   overrides={k: jnp.asarray(v) for k, v in ov_cam.items()})
    rkw_light = dict(jss._sigma_render_kwargs(jcfg, light_n),
                     overrides={k: jnp.asarray(v) for k, v in ov_light.items()})
    assert rkw_cam["compute_dtype"] == jnp.float32
    cache_j = jss._light_cache_render(params, jnp.asarray(tables["light_rays"]),
                                      None, rkw_light)
    with torch.no_grad():
        cache_t = system.light_render(light_n, {k: torch.from_numpy(v) for k, v
                                                in ov_light.items()})
    for k in cache_j:
        # the light rays reach the far plane at 200, where one ulp of a
        # sample's position (XLA and torch round o + d z apart) moves the
        # 2^9-frequency encoding by ~4e-3 rad (worst read on the CPU:
        # 7.6e-6 relative, 5.8e-4 absolute at a depth of 77)
        np.testing.assert_allclose(cache_t[k].numpy(), np.asarray(cache_j[k]),
                                   rtol=1e-4, atol=1e-3, err_msg=k)

    def loss_fn(p):
        cam = jrender(p["coarse"], p["fine"], jnp.asarray(rays), None, **rkw_cam)
        light = (jss._light_cache_render(p, jnp.asarray(tables["light_rays"]),
                                         None, rkw_light)
                 if grad_on_light else cache_j)
        out = jefficient_sm(
            jnp.asarray(pixels), jnp.asarray(tables["light_pixels"]), cam, light,
            jnp.asarray(tables["cam_ms"])[pidx], jnp.asarray(tables["cam_eyes"])[pidx],
            jnp.asarray(tables["light_m"]), jnp.asarray(tables["light_eye"]),
            (WH, WH), fine_sampling=True, light_has_fine=light_n > 0,
            shadow_method="shadow_method_2", pose_idx=jnp.asarray(pidx),
            num_poses=3)
        loss = jmse(out, jnp.asarray(rgbs))
        op_in = {"opacity_coarse": light["opacity_coarse"][:B]}
        if light_n > 0:
            op_in["opacity_fine"] = light["opacity_fine"][:B]
        return loss, (jpsnr(out["rgb_fine"], jnp.asarray(rgbs)),
                      jopacity(op_in, jnp.asarray(rgbs)))

    (loss_j, (psnr_j, op_j)), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    loss, psnr, op = system.train_step(
        *(torch.from_numpy(a) for a in (rays, rgbs, pixels, pidx)),
        {k: v.clone() for k, v in cache_t.items()}, light_n,
        overrides={"cam": {k: torch.from_numpy(v) for k, v in ov_cam.items()},
                   "light": {k: torch.from_numpy(v) for k, v in ov_light.items()}})
    # f32 through both pipelines: the order of the sums only
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(psnr), float(psnr_j), rtol=1e-5)
    np.testing.assert_allclose(float(op), float(op_j), rtol=1e-5)
    assert float(op) != 0.0
    n_grads = 0
    for name, model in system.models.items():
        for pname, p in model.named_parameters():
            ref = _leaf(grads_j[name], pname)
            # sigma-only renders leave the direction head out: no grad in
            # torch's posenc + NeRF, zeros in JAX and the fused route
            got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
            scale = np.abs(ref).max()
            if scale == 0:
                assert np.abs(got).max() == 0, (name, pname)
                continue
            d = np.abs(got - ref) / scale
            # relative to each tensor's largest grad.  f32 sums in another
            # order, the encoding's reading of the far samples (above), and
            # the fine samples: the sampler's bins follow the coarse weights,
            # so a rounding-level change can move a sample to the next bin.
            # Worst on the CPU: 2.0e-3 max (fine xyz_layers.7.w) and 3.0e-5
            # mean over a tensor of 64 values or more (fine xyz_layers.6.b)
            assert d.max() <= 5e-3, (name, pname, d.max())
            if d.size >= 64:
                assert d.mean() <= 1e-4, (name, pname, d.mean())
            n_grads += 1
    assert n_grads >= 12


# ----------------------------------------------------- two-epoch trajectory
def _jax_epochs(js, n_epochs):
    """The JAX system's fit loop without validation: per-step losses."""
    losses, gstep = [], 0
    for epoch in range(n_epochs):
        light_n = js._resolve_light_n(epoch)
        cache = js._init_light_cache()
        js.rng, ek = jax.random.split(js.rng)
        fn = js._epoch_fn_for(light_n, None)
        js.params, js.opt_state, cache, lk, _, _ = fn(
            js.params, js.opt_state, cache, js.rays_buf, js.rgbs_buf,
            js.pixels_buf, js.pose_idx_buf, js.light_rays_in, js._tables(), ek,
            jnp.int32(gstep), jnp.int32(0))
        losses.extend(np.asarray(lk).tolist())
        gstep += js.steps_per_epoch
    return losses


@pytest.mark.parametrize("grad_on_light", [False, True], ids=["cache", "gol"])
def test_two_epoch_trajectory_matches_jax(scene, tmp_path, grad_on_light):
    """perturb 0, noise 0: both packages are deterministic (the fine
    sampling takes kernel B's plain version); 3 steps an epoch against a
    refresh every 2 steps, so epoch 1 also refreshes at its first step."""
    kw = dict(perturb=0.0, noise_std=0.0, batch_size=64, Light_N_importance=8,
              grad_on_light=grad_on_light, lr=LAUNCHER_LR)
    system = _port(scene, tmp_path / "t", **kw)
    start = str(tmp_path / "start.ckpt")
    tckpt.save_checkpoint(start, {"params": system.models})
    js = jss.EfficientSMSystem(jconfig.Config(**_kw(scene, tmp_path / "j",
                                                    ckpt_path=start, **kw)))
    assert js.mesh.devices.size == 1 and js.steps_per_epoch == 3
    losses_j = _jax_epochs(js, 2)
    losses, gstep = [], 0
    for epoch in range(2):
        losses.extend(system.train_epoch(epoch, gstep)["train/loss"].tolist())
        gstep += system.steps_per_epoch
    assert len(losses) == len(losses_j) == 6
    # The shadow map is discontinuous in the weights: a projection that
    # crosses a light pixel's edge gathers another depth, and one at a
    # segment's min or max moves the whole segment's normalisation.  Adam
    # moves a weight whose grad is at rounding level by up to lr whatever
    # the grad's size, so after the first step the two trajectories take
    # such flips apart.  Worst on the CPU at the launcher's lr: 4.2e-3
    # relative per step, the weights within 2e-6 for 98.7% of them.  A
    # wrong cache schedule (a zero light depth), batch or light pass
    # moves the loss by far more.
    np.testing.assert_allclose(losses, losses_j, rtol=2e-2)
    got = np.concatenate([a.ravel() for name in ("coarse", "fine") for a in
                          jax.tree_util.tree_leaves(nerf_to_numpy(system.models[name]))])
    want = np.concatenate([np.asarray(b).ravel() for name in ("coarse", "fine")
                           for b in jax.tree_util.tree_leaves(js.params[name])])
    d = np.abs(got - want)
    assert d.max() <= 6 * 2 * LAUNCHER_LR, d.max()
    assert (d <= 2e-6).mean() >= 0.95, (d <= 2e-6).mean()


# ------------------------------------------------------------ control flow
def test_light_samples_follow_jax_for_minus_one(scene, tmp_path):
    system = _port(scene, tmp_path, Light_N_importance=-1, seed=7,
                   arch_width=NARROW)
    ref = types.SimpleNamespace(cfg=system.cfg)
    got = [system.resolve_light_n(e) for e in range(40)]
    assert got == [jss.EfficientSMSystem._resolve_light_n(ref, e) for e in range(40)]
    assert set(got) == {0, 8, 16, 32}
    system.cfg.Light_N_importance = 16
    assert system.resolve_light_n(3) == 16


@pytest.mark.parametrize("grad_on_light", [False, True], ids=["cache", "gol"])
def test_light_renders_per_step(scene, tmp_path, grad_on_light):
    """Without grad_on_light the cache is re-rendered without grad at steps
    where global_step % k == 0 and at each epoch's first; with it the loss
    renders the light with grad every step (k forced to 1)."""
    system = _port(scene, tmp_path, grad_on_light=grad_on_light,
                   sample_light_depth_every=4, batch_size=64,  # 3 steps/epoch
                   arch_width=NARROW)
    assert system.cfg.sample_light_depth_every == (1 if grad_on_light else 4)
    calls, real = [], system.light_render
    step = {"g": 0}

    def spy(light_n, overrides=None):
        calls.append((step["g"], torch.is_grad_enabled()))
        return real(light_n, overrides)

    real_step = system.train_step

    def counting_step(*args, **kw):
        out = real_step(*args, **kw)
        step["g"] += 1
        return out

    system.light_render = spy
    system.train_step = counting_step
    for epoch, g0 in ((0, 0), (1, 3), (2, 6)):
        system.train_epoch(epoch, g0)
    if grad_on_light:
        assert calls == [(g, True) for g in range(9)]
    else:  # k = 4: g 0, 4 and 8, and the epoch starts at g 3 and 6
        assert calls == [(0, False), (3, False), (4, False), (6, False),
                         (8, False)]


def test_batch_larger_than_the_light_view(scene, tmp_path):
    system = _port(scene, tmp_path, batch_size=96, num_epochs=1,
                   arch_width=NARROW)
    assert system.cfg.batch_size > HW
    metrics = system.train_epoch(0, 0)
    assert np.isfinite(metrics["train/train_opactiy"]).all()
    assert len(metrics["train/loss"]) == 2


def test_max_steps_per_dispatch_keeps_the_trajectory(scene, tmp_path):
    finals = []
    for msd in (0, 2):
        system = _port(scene, tmp_path / str(msd), batch_size=64,
                       perturb=0.0, max_steps_per_dispatch=msd,
                       arch_width=NARROW)
        system.fit()
        finals.append([p.detach().clone() for m in system.models.values()
                       for p in m.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*finals))


def test_sigterm_mid_epoch_saves_the_epoch_before(scene, tmp_path):
    class Stop(Exception):
        pass

    def stop(signum, frame):
        raise Stop

    system = _port(scene, tmp_path, batch_size=64, num_epochs=3,
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
    assert n["steps"] == 5
    saved = jckpt.load_checkpoint(str(tmp_path / "ckpts" / "t" / "preempt.ckpt"))
    assert int(saved["epoch"]) == 0  # epoch 1 was incomplete
    assert np.asarray(saved["opt_state"]["0"]["count"]).item() == 5


# -------------------------------------------------------------------- CLI
def _argv(root, tmp, *extra):
    return ["--root_dir", root, "--dataset_name", "efficient_sm",
            "--img_wh", str(WH), str(WH), "--N_samples", "8",
            "--N_importance", "8", "--batch_size", "64", "--num_epochs", "2",
            "--chunk", "128", "--lr", "5e-4", "--noise_std", "0",
            "--grad_on_light", "--Light_N_importance", "8",
            "--shadow_method", "shadow_method_2", "--exp_name", "cli",
            "--arch_width", str(NARROW),
            "--log_dir", str(tmp / "logs"), "--ckpt_dir", str(tmp / "ckpts"),
            *extra]


def test_cli_trains_and_writes_checkpoints_jax_loads(scene, tmp_path, capsys):
    system = sm_main(_argv(scene, tmp_path, "--device", "cpu"))
    out = capsys.readouterr().out
    assert "[sanity]" in out and "epoch 1: sm_loss" in out and "Light_N=8" in out
    with open(tmp_path / "logs" / "cli" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    epochs = [r for r in recs if "train/loss" in r]
    assert len(epochs) == 2
    for r in epochs:
        for k in ("train/loss", "train/psnr", "train/train_opactiy", "lr",
                  "train/rays_per_s"):
            assert np.isfinite(r[k]), k
    assert sum("val/loss" in r for r in recs) == 2
    assert os.path.exists(tmp_path / "logs" / "cli" / "imgs" / "rgb_001.png")
    ckpts = sorted(os.listdir(tmp_path / "ckpts" / "cli"))
    assert ckpts == ["epoch=0.ckpt", "epoch=1.ckpt"]
    path = str(tmp_path / "ckpts" / "cli" / "epoch=1.ckpt")
    # the JAX package reads the file and resumes its trainer from it
    raw = jckpt.load_checkpoint(path)
    np.testing.assert_array_equal(
        np.asarray(raw["params"]["fine"]["sigma"]["w"]),
        nerf_to_numpy(system.models["fine"])["sigma"]["w"])
    js = jss.EfficientSMSystem(jconfig.Config(**_kw(
        scene, tmp_path / "resume", ckpt_path=path, grad_on_light=True,
        Light_N_importance=8, batch_size=64, arch_width=NARROW)))
    assert js.epoch0 == 2
    count = np.asarray(js.opt_state[0].count)
    assert count.size == 1 and int(count.reshape(())) == 2 * system.steps_per_epoch


def test_cli_rejects_other_datasets(scene, tmp_path):
    with pytest.raises(ValueError, match="not supported by this trainer"):
        sm_main(_argv(scene, tmp_path, "--dataset_name", "blender",
                      "--device", "cpu"))
    # pyredner2 trains (test_torch_port_shadow_loaders.py); rgb_sm is the
    # joint trainer's, refused by this CLI as by the JAX script
    with pytest.raises(ValueError, match="not supported by this trainer"):
        sm_main(_argv(scene, tmp_path, "--dataset_name", "rgb_sm",
                      "--device", "cpu"))
    # --per_host_data takes the efficient_sm and rgb_sm loaders, as in JAX
    # (a no-op at one rank); the shadow systems have no streaming path
    with pytest.raises(ValueError, match="supports the efficient_sm and rgb_sm"):
        sm_main(_argv(scene, tmp_path, "--per_host_data", "--dataset_name",
                      "pyredner2", "--device", "cpu"))
    with pytest.raises(ValueError, match="ROADMAP"):
        sm_main(_argv(scene, tmp_path, "--data_device_resident", "false",
                      "--device", "cpu"))
    with pytest.raises(ValueError, match="shuffle=False"):
        sm_main(_argv(scene, tmp_path, "--global_reshuffle", "--device", "cpu"))
    # the vanilla trainer does not take the shadow loader
    with pytest.raises(ValueError, match="ROADMAP"):
        train_main(_argv(scene, tmp_path, "--device", "cpu"))
    with pytest.raises(ValueError, match="ROADMAP"):
        NeRFSystem(tconfig.Config(**_kw(scene, tmp_path)), device="cpu")


def test_cli_defaults_to_cuda(scene, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sm_main(_argv(scene, tmp_path))
