"""The port's ``ShadowsSystem`` (the RGB trainer on shadow data) against the
JAX package's on the CPU: the flattened ray buffers, one training step with
injected random draws, and the CLI."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu import config as jconfig
from nerf_pl_tpu.ops.rendering import render_rays as jrender
from nerf_pl_tpu.training import checkpoints as jckpt
from nerf_pl_tpu.training import shadow_systems as jss
from nerf_pl_tpu.training.losses import mse_loss as jmse
from nerf_pl_tpu.training.metrics import psnr as jpsnr
from nerf_pl_tpu.training.trainer import \
    render_kwargs_from_cfg as jrender_kwargs
from nerf_pl_tpu_torch import config as tconfig
from nerf_pl_tpu_torch.data import synthetic
from nerf_pl_tpu_torch.models.nerf import nerf_to_numpy
from nerf_pl_tpu_torch.train_shadows import main as shadows_main
from nerf_pl_tpu_torch.training.shadow_systems import ShadowsSystem
from test_torch_port_shadow_rgb_sm import assert_grads_match, torch_ov
from test_torch_port_shadow_train import _draws, _params

WH, N_S, N_I = 8, 8, 8
NARROW = 32


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shadows_scene"))
    return synthetic.generate_scene(root, img_wh=WH, n_train=3, n_val=1,
                                    n_test=1)


def _kw(root, tmp, **kw):
    base = dict(root_dir=root, dataset_name="shadows", img_wh=(WH, WH),
                N_samples=N_S, N_importance=N_I, batch_size=32, num_epochs=2,
                chunk=128, lr=5e-4, exp_name="t", log_dir=str(tmp / "logs"),
                ckpt_dir=str(tmp / "ckpts"), num_sanity_val_steps=0,
                num_devices=1)
    base.update(kw)
    return base


@pytest.mark.parametrize("dataset,width,noise,max_rel", [
    ("shadows", 256, True, 5e-2), ("shadows", 256, False, 1e-4),
    ("shadows", NARROW, True, 1e-4), ("rgb_sm", NARROW, True, 1e-4)],
    ids=["shadows-full", "shadows-full-no-noise", "shadows-narrow",
         "rgb_sm-narrow"])
def test_one_step_matches_a_jax_step(scene, tmp_path, dataset, width, noise,
                                     max_rel):
    kw = dict(dataset_name=dataset, perturb=1.0, noise_std=float(noise),
              arch_width=width)
    system = ShadowsSystem(tconfig.Config(**_kw(scene, tmp_path, **kw)),
                           device="cpu")
    jcfg = jconfig.Config(**_kw(scene, tmp_path / "j", **kw))
    js = jss.ShadowsSystem(jcfg)
    # the same flattened buffers, with the loader's own near and far
    np.testing.assert_array_equal(system.rays.numpy(), np.asarray(js.rays_buf))
    np.testing.assert_array_equal(system.rgbs.numpy(), np.asarray(js.rgbs_buf))
    assert system.rays.shape[0] == 3 * WH * WH
    assert system.rays[0, 6:].tolist() == [1.0, 200.0]
    assert system.white_back == (dataset == "rgb_sm")
    with torch.no_grad():
        for m in system.models.values():
            m.sigma.w.mul_(10.0)
    params = _params(system)
    sl = slice(48, 80)
    rays, rgbs = system.rays[sl].numpy(), system.rgbs[sl].numpy()
    ov = _draws(1, 32, N_I, noise)
    rkw = dict(jrender_kwargs(jcfg, js.white_back, train=True), mode="rgb",
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
    # The vanilla step has no shadow map, so 1e-4 of each tensor's largest
    # grad.  But the full width with these noise draws crosses a kink: the
    # grads (not the loss) jump where a point's sigma + noise sits within
    # rounding of the ReLU's 0, or a fine sample within rounding of its
    # bin's edge, and the two packages' float32 sums land on either side.
    # Both f32 pipelines then read up to 3.7e-2 from a float64 render's
    # grads, and JAX and the port 3.4e-2 apart (fine xyz_layers.7.w, on the
    # CPU; 1.6e-3 at most on average over a tensor); other draws 1.1e-3,
    # the same draws without the noise 2.6e-5 (the case beside it, where
    # the coarse model is empty along these rays: its grads are 0 in both)
    assert_grads_match(system, grads_j, max_rel=max_rel,
                       mean_rel=1e-5 if max_rel < 1e-3 else 5e-3,
                       min_tensors=24)


def _argv(root, tmp, *extra):
    return ["--root_dir", root, "--dataset_name", "shadows",
            "--img_wh", str(WH), str(WH), "--N_samples", "8",
            "--N_importance", "8", "--batch_size", "64", "--num_epochs", "2",
            "--chunk", "128", "--lr", "5e-4", "--exp_name", "cli",
            "--arch_width", str(NARROW),
            "--log_dir", str(tmp / "logs"), "--ckpt_dir", str(tmp / "ckpts"),
            *extra]


def test_cli_trains_and_writes_checkpoints_jax_loads(scene, tmp_path, capsys):
    system = shadows_main(_argv(scene, tmp_path, "--device", "cpu"))
    out = capsys.readouterr().out
    assert "[sanity]" in out and "epoch 1: loss" in out
    assert system.steps_per_epoch == 3
    with open(tmp_path / "logs" / "cli" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    epochs = [r for r in recs if "train/loss" in r]
    assert len(epochs) == 2 and all(np.isfinite(r["train/loss"]) for r in epochs)
    path = str(tmp_path / "ckpts" / "cli" / "epoch=1.ckpt")
    raw = jckpt.load_checkpoint(path)
    np.testing.assert_array_equal(
        np.asarray(raw["params"]["fine"]["rgb"]["w"]),
        nerf_to_numpy(system.models["fine"])["rgb"]["w"])
    js = jss.ShadowsSystem(jconfig.Config(**_kw(
        scene, tmp_path / "resume", ckpt_path=path, arch_width=NARROW,
        batch_size=64)))
    assert js.epoch0 == 2
    count = np.asarray(js.opt_state[0].count)
    assert int(count.reshape(())) == 2 * system.steps_per_epoch


def test_cli_rejects_and_defaults_to_cuda(scene, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="not supported by ShadowsSystem"):
        shadows_main(_argv(scene, tmp_path, "--per_host_data", "--device", "cpu"))
    with pytest.raises(ValueError, match="ROADMAP"):
        shadows_main(_argv(scene, tmp_path, "--data_device_resident", "false",
                           "--device", "cpu"))
    # --global_reshuffle re-shards a fresh permutation of the rays, as in JAX
    system = ShadowsSystem(tconfig.get_opts(_argv(scene, tmp_path,
                                          "--global_reshuffle")), device="cpu")
    before = system.rays.clone()
    system._reshuffle_buffers(0)
    assert not torch.equal(system.rays, before)
    assert torch.equal(system.rays.sort(0).values, before.sort(0).values)
    system.logger.close()
    with pytest.raises(ValueError, match="ROADMAP"):
        shadows_main(_argv(scene, tmp_path, "--loss_type", "sm",
                           "--device", "cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shadows_main(_argv(scene, tmp_path))
