"""``--profile`` and ``--debug_nans`` in the port's trainers on the CPU.

``--profile`` traces the first epoch with ``torch.profiler`` into
``<log_dir>/<exp_name>/trace`` as a Chrome-trace JSON, in the trainers whose
JAX counterparts read the flag (``NeRFSystem``, and ``ShadowsSystem`` which
runs its fit); the other shadow systems accept it and write nothing, as
JAX's do.  ``--debug_nans`` raises ``FloatingPointError`` naming the epoch
and step at the first step whose loss, a parameter or a grad is not finite,
in every system; without it a NaN trains on silently.
"""
import glob
import json
import math
import os

import pytest
import torch

from nerf_pl_tpu_torch.config import get_opts
from nerf_pl_tpu_torch.data import synthetic
from nerf_pl_tpu_torch.training.shadow_systems import (EfficientSMSystem,
                                                       ShadowsSystem)
from nerf_pl_tpu_torch.training.trainer import NeRFSystem
from nerf_pl_tpu_torch.utils import profiling


def _argv(root, tmp, *extra):
    return ["--root_dir", str(root), "--dataset_name", "blender",
            "--img_wh", "16", "16", "--N_samples", "8", "--N_importance", "8",
            "--batch_size", "256", "--num_epochs", "2", "--chunk", "256",
            "--lr", "5e-3", "--blender_near", "1", "--blender_far", "12",
            "--white_back", "true", "--arch_width", "32",
            "--num_sanity_val_steps", "0", "--exp_name", "p",
            "--log_dir", str(tmp / "logs"), "--ckpt_dir", str(tmp / "ckpts"),
            *extra]


def _traces(tmp):
    return sorted(glob.glob(str(tmp / "logs" / "p" / "trace" / "*.pt.trace.json")))


def test_profile_traces_the_first_epoch(blender_root, tmp_path):
    system = NeRFSystem(get_opts(_argv(blender_root, tmp_path, "--profile")),
                        device="cpu")
    system.fit()
    traces = _traces(tmp_path)
    assert len(traces) == 1  # the first epoch only
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the step's ops: the renderer's sampling, the MLP, Adam's update
    for op in ("aten::cumsum", "aten::sqrt", "aten::add_"):
        assert op in names, op
    assert sum(n.startswith("aten::") for n in names) > 20


def test_profile_is_off_without_the_flag(blender_root, tmp_path):
    NeRFSystem(get_opts(_argv(blender_root, tmp_path)), device="cpu").fit()
    assert not os.path.exists(tmp_path / "logs" / "p" / "trace")


@pytest.fixture(scope="module")
def shadow_scene(tmp_path_factory):
    return synthetic.generate_scene(str(tmp_path_factory.mktemp("pscene")),
                                    img_wh=8, n_train=2, n_val=1, n_test=0)


def _shadow_argv(root, tmp, dataset, *extra):
    return ["--root_dir", root, "--dataset_name", dataset, "--img_wh", "8",
            "8", "--N_samples", "8", "--N_importance", "8", "--batch_size",
            "32", "--num_epochs", "1", "--chunk", "128", "--lr", "5e-4",
            "--arch_width", "32", "--num_sanity_val_steps", "0",
            "--exp_name", "p", "--log_dir", str(tmp / "logs"),
            "--ckpt_dir", str(tmp / "ckpts"), *extra]


@pytest.mark.parametrize("cls,dataset,traced", [
    (ShadowsSystem, "shadows", True), (EfficientSMSystem, "efficient_sm", False)],
    ids=["shadows", "efficient_sm"])
def test_profile_in_the_shadow_systems_follows_jax(shadow_scene, tmp_path, cls,
                                                   dataset, traced):
    cls(get_opts(_shadow_argv(shadow_scene, tmp_path, dataset, "--profile")),
        device="cpu").fit()
    assert len(_traces(tmp_path)) == int(traced)


def _poison(system):
    with torch.no_grad():
        system.models["coarse"].xyz_layers[0].w[0, 0] = float("nan")


def test_debug_nans_raises_at_the_first_bad_step(blender_root, tmp_path):
    system = NeRFSystem(get_opts(_argv(blender_root, tmp_path, "--debug_nans")),
                        device="cpu")
    system.fit()  # finite: nothing raised
    system = NeRFSystem(get_opts(_argv(blender_root, tmp_path / "b",
                                       "--debug_nans")), device="cpu")
    _poison(system)
    with pytest.raises(FloatingPointError, match="epoch 0, step 0"):
        system.fit()
    # a NaN made in the middle of the fit is caught at that step
    system = NeRFSystem(get_opts(_argv(blender_root, tmp_path / "c",
                                       "--debug_nans")), device="cpu")
    step = system.train_step

    def poisoned_at_step_2(rays, rgbs, overrides=None):
        if system._epoch == 1 and system._step == 2:
            _poison(system)
        return step(rays, rgbs, overrides)

    system.train_step = poisoned_at_step_2
    with pytest.raises(FloatingPointError, match="epoch 1, step 2"):
        system.fit()


def test_without_debug_nans_a_nan_trains_on(blender_root, tmp_path):
    system = NeRFSystem(get_opts(_argv(blender_root, tmp_path)), device="cpu")
    _poison(system)
    system.fit()
    with open(tmp_path / "logs" / "p" / "metrics.jsonl") as f:
        losses = [json.loads(line)["train/loss"] for line in f
                  if "train/loss" in line]
    assert len(losses) == 2 and all(math.isnan(v) for v in losses)


def test_debug_nans_in_a_shadow_system(shadow_scene, tmp_path):
    # a NaN target (a NaN weight would reach the shadow map's pixel indices
    # first); the step's loss is then NaN
    system = EfficientSMSystem(get_opts(_shadow_argv(
        shadow_scene, tmp_path, "efficient_sm", "--debug_nans",
        "--grad_on_light")), device="cpu")
    system.rgbs[40] = float("nan")  # in the second batch of 32
    with pytest.raises(FloatingPointError, match="epoch 0, step 1"):
        system.fit()


def test_raise_if_not_finite_sees_a_grad_or_a_parameter_alone():
    # a parameter too: the fused kernels' ReLU (fmaxf) turns a NaN
    # activation into 0, so on the card a NaN weight can leave the loss and
    # the grads finite
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.tensor([0.0, float("inf"), 0.0])
    with pytest.raises(FloatingPointError, match="epoch 3, step 7"):
        profiling.raise_if_not_finite(torch.tensor(1.0), [p], 3, 7)
    p.grad = torch.zeros(3)
    profiling.raise_if_not_finite(torch.tensor(1.0), [p], 3, 7)
    with torch.no_grad():
        p[1] = float("nan")
    with pytest.raises(FloatingPointError, match="epoch 0, step 1"):
        profiling.raise_if_not_finite(torch.tensor(1.0), [p], 0, 1)


def test_profile_trace_writes_chrome_json(tmp_path):
    with profiling.profile_trace(str(tmp_path / "t"), "cpu"):
        torch.ones(64).cumsum(0)
    (path,) = glob.glob(str(tmp_path / "t" / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::cumsum" in names
    timer = profiling.StepTimer()
    timer.update(1000, 0.5)
    timer.update(1000, 0.5)
    assert timer.rays_per_s == 2000 and timer.ms_per_step == 500
