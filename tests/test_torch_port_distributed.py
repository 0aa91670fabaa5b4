"""The port's data parallelism (``nerf_pl_tpu_torch/parallel/mesh.py``) in
gloo process groups on the CPU, against the JAX package's ``shard_map`` +
``pmean`` over 2 of the 8 virtual CPU devices:

  * one vanilla step and one ``RGBSMSystem --grad_on_light`` step (the light
    view gathered by ``all_gather_tiled``, against
    ``_light_cache_render_sharded``) on two ranks, each with its own rows
    and injected draws: the averaged grads and the parameters after Adam;
    the second also with its bounds cut to the scene, and against one
    process of the port that differentiates both ranks' losses;
  * a one-epoch fit through the launcher at ``--num_devices 2``: the ranks
    end bit-identical, and only rank 0 wrote;
  * ``--per_host_data`` over three ranks of a 4-frame scene (frames 2/1/1);
  * SIGTERM to both ranks of a ``torchrun``-style group mid-epoch.

Every process has its own ``communicate`` timeout.  The workers are
``tests/torch_dist_worker.py``; ``OMP_NUM_THREADS=2`` keeps the ranks off
each other's cores.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from nerf_pl_tpu import config as jconfig
from nerf_pl_tpu.data.blender import BlenderDataset as JBlender
from nerf_pl_tpu.data.blender_efficient_sm import BlenderEfficientShadows as JESM
from nerf_pl_tpu.data.sharding import equalize_rows as jequalize
from nerf_pl_tpu.ops.rendering import render_rays as jrender
from nerf_pl_tpu.ops.shadow_mapping import efficient_sm as jefficient_sm
from nerf_pl_tpu.parallel.mesh import shard_map
from nerf_pl_tpu.training import optim as joptim
from nerf_pl_tpu.training import shadow_systems as jss
from nerf_pl_tpu.training.losses import loss_dict as jloss_dict
from nerf_pl_tpu.training.losses import mse_loss as jmse
from nerf_pl_tpu.training.losses import sm_loss as jsm_loss
from nerf_pl_tpu_torch.data import synthetic
from nerf_pl_tpu_torch.training import checkpoints as tckpt

from test_torch_port_models import np_nerf
from test_torch_port_render import _overrides, _rays
from test_torch_port_shadow_train import _draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
TIMEOUT = 120  # seconds, each process
W, B, LIGHT_N = 32, 32, 8
RGB_W, SM_W = 0.7, 1.3
# the camera's and the light's (near, far) cut to the shadow scene: the
# cameras 4.5-4.9 and the light 9.25 from its centre, everything within 3.7
# of it, so every sample has |x| <= ~4.5
NEAR_FAR = ((1.0, 9.0), (5.5, 13.0))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker_env(rank=None, world=None, port=None) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=REPO + os.pathsep
               + os.path.join(REPO, "tests"))
    if rank is not None:
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
    return env


def finish(procs, timeout=TIMEOUT):
    """Wait for every process (each with its own timeout); kill the rest on
    a failure and raise with the outputs."""
    outs, failed = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            failed = True
        outs.append(out)
        failed |= p.returncode != 0
    if failed:
        for p in procs:
            if p.poll() is None:
                p.kill()
        raise AssertionError("\n\n".join(
            f"rc={p.returncode}\n{o[-4000:]}" for p, o in zip(procs, outs)))
    return outs


def run_launch(tmp, spec: dict, env=None) -> None:
    path = os.path.join(tmp, "launch.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    finish([subprocess.Popen([sys.executable, WORKER, "launch", path],
                             env=env or worker_env(), cwd=REPO, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)])


def read_ranks(log_dir, n):
    recs = []
    for r in range(n):
        with open(os.path.join(log_dir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def _weights():
    trees = {"coarse": np_nerf(41, W=W), "fine": np_nerf(42, W=W)}
    for t in trees.values():  # a partly opaque scene, depths that vary
        t["sigma"]["w"] *= 10.0
    return trees


# ------------------------------------------------------------ the two steps
@pytest.fixture(scope="module")
def steps(tmp_path_factory, blender_root):
    tmp = str(tmp_path_factory.mktemp("dist_steps"))
    trees = _weights()
    weights = os.path.join(tmp, "w.ckpt")
    tckpt.save_checkpoint(weights, {"params": trees})
    scene = synthetic.generate_scene(os.path.join(tmp, "sm"), img_wh=8,
                                     n_train=3, n_val=1, n_test=1)
    inputs = {}
    for r in range(2):
        inputs[f"v_rays_{r}"] = _rays(100 + r, B)
        inputs[f"v_rgbs_{r}"] = np.random.RandomState(110 + r).uniform(
            size=(B, 3)).astype(np.float32)
        for k, v in _overrides(120 + r, B).items():
            inputs[f"v_ov_{r}_{k}"] = v
        for k, v in _draws(130 + r, B, 8, True).items():
            inputs[f"b_cam_{r}_{k}"] = v
    for k, v in _draws(140, 64, LIGHT_N, True).items():  # the whole light view
        inputs[f"b_light_{k}"] = v
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    common = dict(N_samples=8, N_importance=8, chunk=128, lr=5e-4,
                  num_epochs=2, num_sanity_val_steps=0, perturb=1.0,
                  noise_std=1.0, arch_width=W, num_devices=2,
                  ckpt_path=weights, exp_name="t",
                  log_dir=os.path.join(tmp, "logs"),
                  ckpt_dir=os.path.join(tmp, "ckpts"))
    vanilla = dict(common, root_dir=blender_root, dataset_name="blender",
                   img_wh=[16, 16], batch_size=B, white_back=True)
    rgb_sm = dict(common, root_dir=scene, dataset_name="rgb_sm", img_wh=[8, 8],
                  batch_size=B, grad_on_light=True, Light_N_importance=LIGHT_N,
                  shadow_method="shadow_method_2", rgb_weight=RGB_W,
                  sm_weight=SM_W)
    spec = dict(inputs=os.path.join(tmp, "inputs.npz"), out=tmp,
                vanilla=vanilla, rgb_sm=rgb_sm, rgb_sm_rows=[40, 72],
                near_far=NEAR_FAR)
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    finish([subprocess.Popen([sys.executable, WORKER, "steps", path],
                             env=worker_env(r, 2, port), cwd=REPO, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(2)])
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(2)]
    return dict(trees=trees, inputs=inputs, ranks=ranks, vanilla=vanilla,
                rgb_sm=rgb_sm, scene=scene)


def jax_mesh2():
    return Mesh(np.asarray(jax.devices()[:2]), ("rays",))


def _leaf(tree, name):
    for k in name.replace(".", "/").split("/"):
        tree = tree[int(k)] if k.isdigit() else tree[k]
    return np.asarray(tree, np.float32)


def assert_close_per_tensor(got: dict, ref_tree, prefix, tol_max, tol_mean,
                            mean_min_size=1):
    """Every tensor within ``tol_max`` (largest) and ``tol_mean`` (mean, over
    tensors of ``mean_min_size`` values or more) of its reference's largest
    magnitude; returns the worst readings."""
    worst = [0.0, 0.0]
    names = [k[len(prefix):] for k in got if k.startswith(prefix)]
    assert len(names) >= 24
    for name in names:
        ref = _leaf(ref_tree, name)
        d = np.abs(got[prefix + name] - ref)
        scale = np.abs(ref).max()
        if scale == 0:
            assert d.max() == 0, name
            continue
        assert d.max() <= tol_max * scale, (name, d.max() / scale)
        if d.size < mean_min_size:
            continue
        assert d.mean() <= tol_mean * scale, (name, d.mean() / scale)
        worst = [max(worst[0], d.max() / scale), max(worst[1], d.mean() / scale)]
    return worst


def jax_pmean(trees):
    """``pmean`` over the ``'rays'`` axis of 2 CPU devices, each holding one
    of ``trees`` (per-device grads and losses), under ``shard_map``."""
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)
    fn = shard_map(lambda t: jax.tree_util.tree_map(
        lambda x: jax.lax.pmean(x[0], "rays"), t), jax_mesh2(),
        in_specs=(P("rays"),), out_specs=P())
    return jax.jit(fn)(stacked)


def per_device(body, *per_rank_args):
    """``body`` on each device's inputs, run eagerly as the JAX package's
    own tests run the renderer: XLA:CPU's jit of the whole step sums in
    another order and moves importance samples across CDF bins (the
    layer-0 grads then part by 19% of their scale), and an eager
    ``shard_map`` of it takes 51 s."""
    return [body(*args) for args in zip(*per_rank_args)]


def test_vanilla_step_matches_shard_map_pmean(steps):
    inp, ranks = steps["inputs"], steps["ranks"]
    kw = dict(N_samples=8, N_importance=8, perturb=1.0, noise_std=1.0,
              white_back=True)
    loss_fn_inner = jloss_dict["mse"]
    params = jax.tree_util.tree_map(jnp.asarray, steps["trees"])

    def body(rays, rgbs, ov):
        def loss_fn(p):
            res = jrender(p["coarse"], p["fine"], jnp.asarray(rays), None,
                          overrides={k: jnp.asarray(v) for k, v in ov.items()},
                          **kw)
            return loss_fn_inner(res, jnp.asarray(rgbs))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        return grads, loss

    grads, loss = jax_pmean(per_device(
        body, [inp[f"v_rays_{r}"] for r in (0, 1)],
        [inp[f"v_rgbs_{r}"] for r in (0, 1)],
        [{k: inp[f"v_ov_{r}_{k}"] for k in _overrides(0, 1)} for r in (0, 1)]))
    sched = joptim.make_lr_schedule(5e-4, "steplr", 12, 2)
    opt = joptim.get_optimizer("adam", sched)
    upd, _ = opt.update(grads, opt.init(params), params)
    after = jax.tree_util.tree_map(lambda a, b: a + b, params, upd)
    # the ranks' losses are their halves'; JAX's is their pmean
    np.testing.assert_allclose((ranks[0]["v_loss"] + ranks[1]["v_loss"]) / 2,
                               float(loss), rtol=1e-5)
    for rk in ranks:
        # f32 on both sides: the order of the sums only
        assert_close_per_tensor(rk, grads, "v_grad/", 1e-5, 1e-6)
        assert_close_per_tensor(rk, after, "v_param/", 1e-5, 1e-6)
    for name in (k for k in ranks[0] if k.startswith("v_param/")):
        assert np.array_equal(ranks[0][name], ranks[1][name]), name


def _grad_on_light_pmean(steps, tag, bounds=None):
    """JAX's ``pmean`` of the two devices' ``--grad_on_light`` grads and
    losses on the batch rank ``tag`` trained (``bounds``: the camera's and
    the light's near and far, as the worker cut them)."""
    inp, ranks = steps["inputs"], steps["ranks"]
    jcfg = jconfig.Config(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in steps["rgb_sm"].items()})
    batch = {k: np.concatenate([rk[f"{tag}_batch/{k}"] for rk in ranks])
             for k in ("rays", "rgbs", "sms", "pixels", "pose_idx")}
    # the rank's rows of its block, as the worker took them
    assert len(set(batch["pose_idx"].tolist())) == 3
    from nerf_pl_tpu.data.blender_rgb_shadows import BlenderRGBEfficientShadows

    ds = BlenderRGBEfficientShadows(steps["scene"], "train", img_wh=(8, 8))
    tables = {"cam_ms": jnp.asarray(ds.cam_ms), "cam_eyes": jnp.asarray(ds.cam_eyes),
              "light_pixels": jnp.asarray(ds.light.pixels),
              "light_m": jnp.asarray(ds.light.camera),
              "light_eye": jnp.asarray(ds.light.eye_pos)}
    rkw_cam = dict(jss._sigma_render_kwargs(jcfg, 8), mode="rgb_disp",
                   white_back=True)
    rkw_cam.pop("remat_fine")
    rkw_light = jss._sigma_render_kwargs(jcfg, LIGHT_N)

    light_all = ds.light.rays.copy()
    if bounds is not None:
        light_all[:, 6:8] = bounds[1]
    params = jax.tree_util.tree_map(jnp.asarray, steps["trees"])
    n_light = light_all.shape[0] // 2

    def body(r):
        rows = slice(r * B, (r + 1) * B)
        lrows = slice(r * n_light, (r + 1) * n_light)
        rays, rgbs, sms, pixels, pidx = (jnp.asarray(batch[k][rows]) for k in (
            "rays", "rgbs", "sms", "pixels", "pose_idx"))
        ov_cam = {k: jnp.asarray(inp[f"b_cam_{r}_{k}"])
                  for k in _draws(0, 1, 8, True)}
        ov_light = {k: jnp.asarray(inp[f"b_light_{k}"][lrows])
                    for k in _draws(0, 1, LIGHT_N, True)}
        light_rays = jnp.asarray(light_all[lrows])
        # the other device's light slice, rendered as that device renders
        # it (its rows and draws)
        other = 1 - r
        orows = slice(other * n_light, (other + 1) * n_light)
        ov_other = {k: jnp.asarray(inp[f"b_light_{k}"][orows])
                    for k in ov_light}

        def loss_fn(p):
            cam = jrender(p["coarse"], p["fine"], rays, None,
                          **dict(rkw_cam, overrides=ov_cam))
            mine = jss._light_cache_render(p, light_rays, None,
                                           dict(rkw_light, overrides=ov_light))
            theirs = jss._light_cache_render(
                p, jnp.asarray(light_all[orows]), None,
                dict(rkw_light, overrides=ov_other))
            light = {k: jnp.concatenate([mine[k], theirs[k]] if r == 0
                                        else [theirs[k], mine[k]])
                     for k in mine}
            out = jefficient_sm(
                pixels, tables["light_pixels"], cam, light,
                tables["cam_ms"][pidx], tables["cam_eyes"][pidx],
                tables["light_m"], tables["light_eye"], (8, 8),
                fine_sampling=True, light_has_fine=True,
                shadow_method="shadow_method_2", pose_idx=pidx, num_poses=3,
                out_prefix="sm")
            return RGB_W * jmse(out, rgbs) + SM_W * jsm_loss(out, sms)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        return grads, loss

    # under shard_map the tiled all_gather's transpose (psum_scatter) hands
    # each device every device's cotangent of its light rows, so the pmean
    # of the grads is the device-mean of each device's loss differentiated
    # through the whole gathered view: what body differentiates
    return jax_pmean(per_device(body, [0, 1]))


def test_grad_on_light_step_matches_sharded_light_cache(steps):
    ranks = steps["ranks"]
    grads, loss = _grad_on_light_pmean(steps, "b")
    np.testing.assert_allclose((ranks[0]["b_loss"] + ranks[1]["b_loss"]) / 2,
                               float(loss), rtol=1e-5)
    for rk in ranks:
        # the light's far samples (|x| ~ 100, where one ulp moves the
        # 2^9-frequency encoding by ~4e-3 rad) amplify the f32 sum order:
        # the one-process step on this scene reads 6.1e-5 max and 1.4e-6
        # mean (test_torch_port_shadow_rgb_sm.py, narrow); this reads
        # 2.5e-5 and 1.3e-6 on the CPU, the mean over tensors of 64 values
        # or more as there
        assert_close_per_tensor(rk, grads, "b_grad/", 5e-5, 5e-6, 64)


def test_grad_on_light_step_near_scene_matches_sharded_light_cache(steps):
    """The same step with the bounds cut to the scene (every sample within
    |x| ~ 4.5, as in the Blender scenes)."""
    ranks = steps["ranks"]
    grads, loss = _grad_on_light_pmean(steps, "n", NEAR_FAR)
    np.testing.assert_allclose((ranks[0]["n_loss"] + ranks[1]["n_loss"]) / 2,
                               float(loss), rtol=1e-5)
    for rk in ranks:
        # no better than on the loader's bounds: this reads 3.1e-5 max, on
        # the fine sigma head's bias (the sum of every point's dsigma), and
        # at most 6.4e-6 on every other tensor; the sum order of the sigma
        # head's grads, not the far samples, parts the two f32 steps
        assert_close_per_tensor(rk, grads, "n_grad/", 5e-5, 5e-6, 64)


def _one_process_grads(steps, tag, bounds=None):
    """The port's ``--grad_on_light`` grads in this one process, without a
    group: each rank's loss on its rows (the light view whole, with every
    rank's draws) differentiated in turn, and the two averaged."""
    from nerf_pl_tpu_torch.config import Config
    from nerf_pl_tpu_torch.training.shadow_systems import RGBSMSystem

    inp, ranks = steps["inputs"], steps["ranks"]
    sm = RGBSMSystem(Config(**dict(steps["rgb_sm"], num_devices=1)),
                     device="cpu")
    if bounds is not None:
        sm.light_rays[:, 6:8] = torch.tensor(bounds[1])
    draws = lambda prefix: {k: torch.from_numpy(inp[prefix + k])  # noqa: E731
                            for k in _draws(0, 1, LIGHT_N, True)}
    total: dict = {}
    for r, rk in enumerate(ranks):
        b = {k: torch.from_numpy(rk[f"{tag}_batch/{k}"])
             for k in ("rays", "rgbs", "sms", "pixels", "pose_idx")}
        sm.optimizer.zero_grad()
        out, _ = sm._shadow_out(
            b["rays"], b["pixels"], b["pose_idx"], None, LIGHT_N,
            {"cam": draws(f"b_cam_{r}_"), "light": draws("b_light_")},
            out_prefix="sm")
        sm._loss(out, b["rgbs"], b["sms"])[0].backward()
        for k, p in sm.optimizer.params.items():
            node = total
            *path, leaf = [int(q) if q.isdigit() else q for q in k.split("/")]
            for q in path:
                node = node.setdefault(q, {})
            g = p.grad.numpy() if p.grad is not None else 0.0
            node[leaf] = node.get(leaf, 0.0) + g / 2
    sm.logger.close()
    return total


@pytest.mark.parametrize("tag", ["b", "n"])
def test_grad_on_light_two_ranks_match_one_process(steps, tag):
    """The collectives alone, without JAX: the two ranks' averaged grads
    (the light view gathered, its cotangent summed over the ranks) against
    one process of the port on the same rows and draws.  Only the order of
    the sums over points differs (each rank's light slice and camera rows
    apart, then the all-reduce); it reads at most 1.6e-6 max and 1.1e-6 on
    the one-value sigma bias, on either scene's bounds."""
    ref = _one_process_grads(steps, tag, NEAR_FAR if tag == "n" else None)
    for rk in steps["ranks"]:
        assert_close_per_tensor(rk, ref, f"{tag}_grad/", 1e-5, 1e-6, 64)


# ------------------------------------------------------------ fits
def _fit_argv(root, tmp, *extra):
    return ["--root_dir", root, "--img_wh", "16", "16", "--N_samples", "8",
            "--N_importance", "8", "--batch_size", str(B), "--num_epochs", "1",
            "--chunk", "256", "--lr", "5e-4", "--arch_width", str(W),
            "--exp_name", "d", "--log_dir", os.path.join(tmp, "logs"),
            "--ckpt_dir", os.path.join(tmp, "ckpts"), "--device", "cpu",
            *extra]


def test_two_rank_fit_ends_identical_and_rank0_writes(blender_root, tmp_path):
    tmp = str(tmp_path)
    run_launch(tmp, dict(system="NeRFSystem", argv=_fit_argv(
        blender_root, tmp, "--dataset_name", "blender", "--num_devices", "2",
        "--white_back", "true")))
    recs = read_ranks(os.path.join(tmp, "logs"), 2)
    assert recs[0]["digest"] == recs[1]["digest"]
    # 3 frames of 16x16 over 2 ranks: 384 rows each, 12 steps of 32
    assert [r["rows"] for r in recs] == [384, 384]
    assert recs[0]["steps_per_epoch"] == 12
    assert [r["wrote_logs"] for r in recs] == [True, False]
    assert recs[0]["checkpoint_writes"] == ["epoch=0.ckpt"]
    assert recs[1]["checkpoint_writes"] == []
    with open(os.path.join(tmp, "logs", "d", "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert sum("train/loss" in x for x in lines) == 1  # one writer
    assert sorted(os.listdir(os.path.join(tmp, "ckpts", "d"))) == ["epoch=0.ckpt"]


@pytest.mark.parametrize("system,dataset", [("NeRFSystem", "blender"),
                                            ("EfficientSMSystem", "efficient_sm")])
def test_uneven_per_host_shards(system, dataset, blender_root4, shadow_root4,
                                tmp_path):
    """Three ranks of a 4-frame scene: frames [0, 3], [1], [2] wrap-padded to
    two each; the rows after ``equalize_rows`` are JAX's."""
    root = blender_root4 if dataset == "blender" else shadow_root4
    wh = 16 if dataset == "blender" else 8
    tmp = str(tmp_path)
    argv = _fit_argv(root, tmp, "--dataset_name", dataset, "--num_devices",
                     "3", "--per_host_data", "--img_wh", str(wh), str(wh))
    if dataset == "efficient_sm":
        argv += ["--Light_N_importance", "8", "--noise_std", "0"]
    run_launch(tmp, dict(system=system, argv=argv))
    recs = read_ranks(os.path.join(tmp, "logs"), 3)
    assert len({r["digest"] for r in recs}) == 1
    if dataset == "blender":
        counts = [JBlender(root, "train", img_wh=(wh, wh),
                           frame_shard=(r, 3)).all_rays.shape[0]
                  for r in range(3)]
    else:
        counts = [JESM(root, "train", img_wh=(wh, wh),
                       frame_shard=(r, 3)).all_rays.shape[0] for r in range(3)]
    assert counts == [2 * wh * wh] * 3  # 2/1/1 frames, wrap-padded to 2
    target = max(counts)
    want = [len(jequalize([np.zeros((c, 1))], c, target)[0]) for c in counts]
    assert [r["rows"] for r in recs] == [min(want)] * 3


# ------------------------------------------------------------ SIGTERM
def test_sigterm_stops_both_ranks_with_one_checkpoint(blender_root, tmp_path):
    tmp = str(tmp_path)
    argv = _fit_argv(blender_root, tmp, "--dataset_name", "blender",
                     "--multihost", "--num_epochs", "10000",
                     "--num_sanity_val_steps", "0", "--val_every_n_epochs",
                     "10000")
    port = free_port()
    logs = [open(os.path.join(tmp, f"out{r}.txt"), "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-m", "nerf_pl_tpu_torch.train",
                               *argv], env=worker_env(r, 2, port), cwd=REPO,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(2)]
    metrics = os.path.join(tmp, "logs", "d", "metrics.jsonl")
    t0 = time.time()
    try:
        while not (os.path.exists(metrics) and os.path.getsize(metrics)):
            assert time.time() - t0 < TIMEOUT, "no epoch finished"
            assert all(p.poll() is None for p in procs), "a rank exited"
            time.sleep(0.2)
        time.sleep(0.3)  # into the next epoch's steps
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    outs = [open(os.path.join(tmp, f"out{r}.txt")).read() for r in range(2)]
    assert [p.returncode for p in procs] == [-signal.SIGTERM] * 2, outs
    ckpts = os.listdir(os.path.join(tmp, "ckpts", "d"))
    assert ckpts.count("preempt.ckpt") == 1, ckpts
    saved = tckpt.load_checkpoint(os.path.join(tmp, "ckpts", "d",
                                               "preempt.ckpt"))
    assert int(saved["epoch"]) >= 0
