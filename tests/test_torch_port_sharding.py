"""The port's data layout over ranks against the JAX package's on the CPU:
``data/sharding.py`` (``wrap_pad_shard``, ``equalize_rows``), ``plan_chunks``,
``shard_rays`` against each device's rows of JAX's ``shard_rays`` on the
8-device CPU mesh, the loaders' ``frame_shard``, and ``--global_reshuffle``'s
per-rank rows against the JAX trainer's ``_reshuffle_buffers``.  No process
group: the rank a function sees is a ``Mesh`` value.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import jax
from nerf_pl_tpu import config as jconfig
from nerf_pl_tpu.data import sharding as jsharding
from nerf_pl_tpu.data.blender import BlenderDataset as JBlender
from nerf_pl_tpu.parallel import mesh as jmesh
from nerf_pl_tpu.tools.render import plan_chunks as jplan_chunks
from nerf_pl_tpu.training.trainer import NeRFSystem as JNeRFSystem
from nerf_pl_tpu_torch.config import Config
from nerf_pl_tpu_torch.data import sharding
from nerf_pl_tpu_torch.data.blender import BlenderDataset
from nerf_pl_tpu_torch.parallel import mesh as pmesh
from nerf_pl_tpu_torch.tools.render import plan_chunks
from nerf_pl_tpu_torch.training.trainer import NeRFSystem


@pytest.mark.parametrize("n_items", [1, 2, 3, 4, 5, 7, 8, 13])
def test_wrap_pad_shard_and_equalize_rows_match_jax(n_items):
    items = [f"f{i}" for i in range(n_items)]
    for step in (1, 2, 3, 4, 8):
        for offset in range(step):
            try:
                want = jsharding.wrap_pad_shard(items, (offset, step))
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    sharding.wrap_pad_shard(items, (offset, step))
                assert str(got.value) == str(e)  # the message, word for word
                continue
            assert sharding.wrap_pad_shard(items, (offset, step)) == want
            assert (sharding.wrap_pad_shard(items, (offset, step), "images")
                    == jsharding.wrap_pad_shard(items, (offset, step), "images"))
    rng = np.random.RandomState(n_items)
    bufs = [rng.rand(n_items, 3).astype(np.float32),
            rng.randint(0, 9, (n_items, 1)).astype(np.int32)]
    for target in (0, n_items, n_items + 1, 3 * n_items + 2):
        got = sharding.equalize_rows(bufs, n_items, target)
        want = jsharding.equalize_rows(bufs, n_items, target)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_plan_chunks_matches_jax():
    for n in (1, 7, 64, 100, 256, 1000, 4096, 160_000):
        for chunk in (1, 8, 100, 1024, 32_768):
            for d in (1, 2, 3, 4, 8):
                assert plan_chunks(n, chunk, d) == jplan_chunks(n, chunk, d)


def _jax_blocks(buf: np.ndarray, d: int, local: bool):
    """Each device's rows of JAX's ``shard_rays`` over ``d`` CPU devices."""
    mesh = JMesh(np.asarray(jax.devices()[:d]), ("rays",))
    arr = jmesh.shard_rays(buf, mesh, local=local)
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start or 0)
    return [np.asarray(s.data) for s in shards]


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
@pytest.mark.parametrize("n", [16, 61, 100])
@pytest.mark.parametrize("d", [2, 3, 8])
def test_shard_rays_rows_match_jax_devices(d, n, local, monkeypatch):
    buf = np.random.RandomState(n).rand(n, 5).astype(np.float32)
    want = _jax_blocks(buf, d, local=False)
    if not local:
        for r in range(d):
            got = pmesh.shard_rays(buf, pmesh.Mesh(d, r))
            assert np.array_equal(got, want[r]), r
        return
    # local=True: each rank holds only its own rows; with every rank holding
    # its JAX device's block (one process, where JAX's local flag is moot)
    # the rows are that block, and ranks of uneven counts keep the global
    # minimum (the all-reduce of an int64, here over the given counts)
    jlocal = _jax_blocks(buf, d, local=True)
    counts = [len(w) + (r % 2) for r, w in enumerate(want)]
    monkeypatch.setattr(pmesh, "allreduce_int",
                        lambda v, mesh, op: min(counts))
    for r in range(d):
        mine = np.concatenate([want[r], buf[:r % 2]])
        assert len(mine) == counts[r]
        got = pmesh.shard_rays(mine, pmesh.Mesh(d, r), local=True)
        assert np.array_equal(got, jlocal[r]), r
    assert torch.equal(pmesh.shard_rays(torch.from_numpy(buf), pmesh.Mesh(d, 1)),
                       torch.from_numpy(want[1]))


def test_blender_frame_shards_match_jax(blender_root4):
    for offset in range(3):
        kw = dict(img_wh=(16, 16), frame_shard=(offset, 3))
        mine = BlenderDataset(blender_root4, "train", **kw)
        ref = JBlender(blender_root4, "train", **kw)
        for key in ("all_rays", "all_rgbs", "poses"):
            assert np.array_equal(getattr(mine, key), getattr(ref, key)), key
        assert mine.image_paths == ref.image_paths
    with pytest.raises(ValueError, match="host 4 gets no frames"):
        BlenderDataset(blender_root4, "train", img_wh=(16, 16),
                       frame_shard=(4, 5))


def _cfg_kw(root, tmp):
    return dict(root_dir=root, dataset_name="blender", img_wh=(16, 16),
                N_samples=8, N_importance=8, batch_size=64, num_epochs=3,
                chunk=256, lr=5e-4, blender_near=1.0, blender_far=12.0,
                white_back=True, exp_name="t", log_dir=str(tmp / "logs"),
                ckpt_dir=str(tmp / "ckpts"), global_reshuffle=True,
                num_sanity_val_steps=0)


def test_global_reshuffle_rows_match_jax(blender_root, tmp_path):
    """Each rank's rows after ``_reshuffle_buffers`` at epochs 0-2 equal its
    device's rows of the JAX trainer's re-sharded buffers, bit for bit."""
    d = 2
    jsys = JNeRFSystem(jconfig.Config(**_cfg_kw(blender_root, tmp_path / "j"),
                                      num_devices=d))
    system = NeRFSystem(Config(**_cfg_kw(blender_root, tmp_path / "p")),
                        device="cpu")
    assert np.array_equal(system._host_rays, jsys._host_rays)
    for epoch in range(3):
        jsys._reshuffle_buffers(epoch)
        blocks = {}
        for name in ("rays_buf", "rgbs_buf"):
            shards = sorted(getattr(jsys, name).addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            blocks[name] = [np.asarray(s.data) for s in shards]
        for r in range(d):
            system.mesh = pmesh.Mesh(d, r)
            system._reshuffle_buffers(epoch)
            assert np.array_equal(system.rays.numpy(), blocks["rays_buf"][r])
            assert np.array_equal(system.rgbs.numpy(), blocks["rgbs_buf"][r])
    system.logger.close()
    jsys.logger.close()


def test_dryrun_multichip_two_ranks():
    """``graft_entry.dryrun_multichip(2)`` on two gloo ranks of the CPU: one
    data-parallel step, the ranks' parameters equal after it."""
    from test_torch_port_distributed import REPO, TIMEOUT, finish, worker_env

    code = ("from nerf_pl_tpu_torch.graft_entry import dryrun_multichip; "
            "dryrun_multichip(2, device='cpu')")
    out, = finish([subprocess.Popen([sys.executable, "-c", code],
                                    env=worker_env(), cwd=REPO, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)], TIMEOUT)
    assert "dryrun_multichip(2): OK" in out
    assert "parameters equal on every rank" in out


def test_launcher_world_size(monkeypatch):
    """``--num_devices`` unset means every visible device (one process on
    the CPU); more ranks than visible cards raises with both numbers."""
    from nerf_pl_tpu_torch.training.launch import world_size

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert world_size(Config(), cpu) == 1
    assert world_size(Config(num_devices=3), cpu) == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert world_size(Config(), cuda) == 2
    with pytest.raises(ValueError, match="--num_devices 3 exceeds the 2 visible"):
        world_size(Config(num_devices=3), cuda)
    with pytest.raises(ValueError, match="must be positive"):
        world_size(Config(num_devices=0), cpu)
