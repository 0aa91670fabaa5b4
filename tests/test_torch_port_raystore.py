"""The port's native ray store (``nerf_pl_tpu_torch/data/native.py``, its own
build of ``native/raystore.cpp`` under ``build/``) against the JAX package's
``RayStore``, and the streaming epoch (``--data_device_resident false``)
against the JAX trainer's slab layout, at one rank and at two gloo ranks.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from nerf_pl_tpu.data.native import RayStore as JRayStore
from nerf_pl_tpu_torch.config import get_opts
from nerf_pl_tpu_torch.data import native
from nerf_pl_tpu_torch.data.native import RayStore
from nerf_pl_tpu_torch.training.trainer import NeRFSystem

from test_torch_port_distributed import (REPO, WORKER, finish, read_ranks,
                                         worker_env)


def _columns(n=1000, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(n, 8).astype(np.float32), rng.rand(n, 3).astype(np.float32)]


@pytest.mark.parametrize("fallback", [False, True], ids=["native", "numpy"])
def test_store_matches_jax_bit_for_bit(fallback):
    cols = _columns()
    mine = RayStore(cols, seed=7, force_fallback=fallback)
    ref = JRayStore(cols, seed=7, force_fallback=fallback)
    assert mine.native == ref.native == (not fallback)
    if not fallback:
        assert str(native.library_path()).startswith(
            os.path.join(REPO, "build", "nerf_pl_tpu_torch"))
    for epoch in (0, 1, 5):
        assert np.array_equal(mine.epoch_perm(epoch), ref.epoch_perm(epoch))
        for step, batch in ((0, 64), (3, 100), (15, 64), (9, 100), (40, 64)):
            a, b = mine.fill_batch(epoch, step, batch), ref.fill_batch(
                epoch, step, batch)
            assert a.shape == b.shape and np.array_equal(a, b), (epoch, step)
    assert mine.fill_batch(0, 16, 64).shape == (0, 11)  # past the end
    for start, batch in ((0, 64), (990, 64), (1000, 8), (5000, 8)):
        assert np.array_equal(mine.fill_sequential(start, batch),
                              ref.fill_sequential(start, batch))
    rows = mine.fill_batch(2, 1, 32)
    for a, b in zip(mine.split(rows), ref.split(rows)):
        assert np.array_equal(a, b)
    out = np.empty((32, 11), np.float32)
    assert mine.fill_batch(2, 1, 32, out=out) is not None
    assert np.array_equal(out, rows)
    with pytest.raises(ValueError, match="C-contiguous float32"):
        mine.fill_batch(2, 1, 32, out=np.empty((32, 11), np.float64))


def jax_slab_rows(store: JRayStore, epoch: int, steps: int, slab: int, B: int,
                  d: int, rank: int):
    """Rank ``rank``'s rays of each step of JAX's ``_run_streaming_epoch``:
    ``k`` global batches of ``B d`` rows stacked into a ``P('rays')`` slab
    (d contiguous blocks of ``k B`` rows), scanned in ``B``-row slices."""
    out, step = [], 0
    while step < steps:
        k = min(slab, steps - step)
        rows = np.concatenate([store.fill_batch(epoch, step + j, B * d)
                               for j in range(k)])
        mine = rows[rank * k * B:(rank + 1) * k * B]
        out += [store.split(mine[j * B:(j + 1) * B])[0] for j in range(k)]
        step += k
    return out


def _argv(root, tmp, *extra):
    return ["--root_dir", root, "--dataset_name", "blender", "--img_wh", "16",
            "16", "--N_samples", "8", "--N_importance", "8", "--batch_size",
            "32", "--num_epochs", "2", "--chunk", "256", "--lr", "5e-4",
            "--arch_width", "32", "--white_back", "true",
            "--num_sanity_val_steps", "0", "--exp_name", "s",
            "--log_dir", str(tmp / "logs"), "--ckpt_dir", str(tmp / "ckpts"),
            "--data_device_resident", "false", *extra]


def test_streaming_fit_one_rank_takes_jax_slab_rows(blender_root, tmp_path):
    system = NeRFSystem(get_opts(_argv(blender_root, tmp_path,
                                       "--stream_slab_steps", "5")),
                        device="cpu")
    assert system.ray_store.native and not hasattr(system, "rays")
    seen = []
    step = system.train_step

    def recording(rays, rgbs, **kw):
        seen.append(rays.numpy().copy())
        return step(rays, rgbs, **kw)

    system.train_step = recording
    system.fit()
    ds = system.train_dataset
    store = JRayStore([ds.all_rays, ds.all_rgbs], seed=0)
    steps = system.steps_per_epoch
    assert steps == 768 // 32
    want = [r for e in range(2)
            for r in jax_slab_rows(store, e, steps, 5, 32, 1, 0)]
    assert len(seen) == len(want)
    for a, b in zip(seen, want):
        assert np.array_equal(a, b)
    assert system.slab_copies == 2 * -(-steps // 5)


def test_streaming_fit_two_ranks_take_jax_slab_rows(blender_root, tmp_path):
    tmp = str(tmp_path)
    spec = dict(system="NeRFSystem", argv=_argv(
        blender_root, tmp_path, "--num_devices", "2", "--device", "cpu",
        "--stream_slab_steps", "4"))
    path = os.path.join(tmp, "launch.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(worker_env(), PORT_TEST_RECORD_ROWS="1")
    finish([subprocess.Popen([sys.executable, WORKER, "launch", path], env=env,
                             cwd=REPO, text=True, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)])
    recs = read_ranks(str(tmp_path / "logs"), 2)
    assert recs[0]["digest"] == recs[1]["digest"]
    from nerf_pl_tpu_torch.data.blender import BlenderDataset

    ds = BlenderDataset(blender_root, "train", img_wh=(16, 16), white_back=True)
    store = JRayStore([ds.all_rays, ds.all_rgbs], seed=0)
    steps = recs[0]["steps_per_epoch"]
    assert steps == (768 // 2) // 32
    for r in range(2):
        seen = np.load(str(tmp_path / "logs" / f"rank{r}_rows.npy"))
        want = [x for e in range(2)
                for x in jax_slab_rows(store, e, steps, 4, 32, 2, r)]
        assert np.array_equal(seen, np.stack(want)), r
        assert recs[r]["slab_copies"] == 2 * -(-steps // 4)


def test_stream_slab_steps_zero_negative_and_three(blender_root, tmp_path):
    def build(n, *extra):
        return NeRFSystem(get_opts(_argv(blender_root, tmp_path,
                                         "--stream_slab_steps", str(n),
                                         *extra)), device="cpu")

    assert build(0).stream_slab_steps == 16  # 0 keeps the default, as in JAX
    assert build(3).stream_slab_steps == 3
    with pytest.raises(ValueError,
                       match=r"--stream_slab_steps must be positive \(got -2\)"):
        build(-2)
    # device-resident runs do not read the flag (JAX checks it only when
    # streaming)
    NeRFSystem(get_opts(_argv(blender_root, tmp_path, "--stream_slab_steps",
                              "-2", "--data_device_resident", "true")),
               device="cpu")
    # --per_host_data is refused with streaming at more than one rank (at
    # one it is a no-op, as in JAX)
    system = build(3, "--per_host_data")
    system.mesh.size = 2
    with pytest.raises(ValueError, match="requires device-resident"):
        system._prepare_data()
