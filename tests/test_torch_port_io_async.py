"""The port's ``AsyncWriter`` (``nerf_pl_tpu_torch/utils/io_async.py``): the
five cases of ``tests/test_io_async.py`` against the port's class, its
device snapshots, and a fit whose checkpoints are all on disk when ``fit``
returns although every write is slow."""
import os
import threading
import time

import numpy as np
import pytest
import torch

from nerf_pl_tpu_torch.config import get_opts
from nerf_pl_tpu_torch.data.synthetic import generate_scene
from nerf_pl_tpu_torch.training import checkpoints
from nerf_pl_tpu_torch.training.trainer import NeRFSystem
from nerf_pl_tpu_torch.utils.io_async import AsyncWriter, snapshot


def test_writer_preserves_submission_order():
    w = AsyncWriter()
    seen = []
    for i in range(50):
        w.submit(lambda i=i: seen.append(i))
    w.drain()
    assert seen == list(range(50))


def test_writer_error_surfaces_on_drain_and_clears():
    w = AsyncWriter()
    w.submit(lambda: 1 / 0)
    with pytest.raises(RuntimeError, match="background write failed"):
        w.drain()
    # a surfaced error must not wedge the writer
    ok = []
    w.submit(lambda: ok.append(1))
    w.drain()
    assert ok == [1]


def test_writer_error_surfaces_on_next_submit():
    w = AsyncWriter()
    w.submit(lambda: 1 / 0)
    time.sleep(0.2)
    with pytest.raises(RuntimeError):
        w.submit(lambda: None)


def test_drain_timeout_returns_instead_of_deadlocking():
    """The preemption save drains with a timeout: a write blocked on a
    resource the main thread holds must not deadlock the save."""
    gate = threading.Event()
    w = AsyncWriter(name="t-drain")
    w.submit(gate.wait)  # blocks until released
    t0 = time.monotonic()
    w.drain(timeout=0.3)  # must return, not hang
    assert time.monotonic() - t0 < 2.0
    gate.set()
    w.drain()  # now completes fully and re-raises nothing
    # repeated timed-out drains must not accumulate waiter threads
    gate2 = threading.Event()
    w.submit(gate2.wait)
    before = threading.active_count()
    for _ in range(5):
        w.drain(timeout=0.05)
    assert threading.active_count() <= before
    gate2.set()
    w.drain()


def test_drain_timeout_still_surfaces_prior_failure():
    """A timed-out drain must re-raise an error from a write that did
    complete — the timeout path cannot swallow it."""
    gate0 = threading.Event()
    gate = threading.Event()
    w = AsyncWriter(name="t-drain-err")

    def failing():
        gate0.wait()
        raise ValueError("boom")

    w.submit(failing)     # held until gate0 — both submits succeed
    w.submit(gate.wait)   # keeps the queue non-empty past the timeout
    gate0.set()
    time.sleep(0.2)       # failure lands while gate.wait blocks
    with pytest.raises(RuntimeError, match="background write failed"):
        w.drain(timeout=0.2)
    gate.set()
    w.drain()


def test_snapshot_is_not_the_live_tensor():
    """An in-place update after ``snapshot`` (as the next optimiser step
    makes) does not reach what the writer fetches."""
    p = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    tree = {"w": p, "list": [p[0], 7], "n": np.int32(3), "t": (p.sum(),)}
    snap = snapshot(tree)
    p.add_(100.0)
    host = snap.fetch()
    np.testing.assert_array_equal(host["w"].numpy(),
                                  np.arange(6).reshape(2, 3))
    np.testing.assert_array_equal(host["list"][0].numpy(), [0, 1, 2])
    assert host["list"][1] == 7 and host["n"] == 3
    assert isinstance(host["t"], tuple) and float(host["t"][0]) == 15.0


def test_fit_leaves_every_checkpoint_on_disk(tmp_path, monkeypatch):
    """Every write sleeps, so the epochs outrun the writer; ``fit`` still
    returns with every checkpoint it kept on disk and loadable, the top 5
    by val loss pruned in submission order, and the weights each holds are
    the weights of its epoch, not of a later step."""
    root = str(tmp_path / "scene")
    generate_scene(root, img_wh=16, n_train=2, n_val=1, n_test=1)
    save = checkpoints.save_checkpoint
    weights = {}

    def slow_save(path, state):
        time.sleep(0.3)
        save(path, state)

    monkeypatch.setattr(checkpoints, "save_checkpoint", slow_save)
    argv = ["--root_dir", root, "--dataset_name", "blender", "--img_wh", "16",
            "16", "--N_samples", "4", "--N_importance", "4", "--batch_size",
            "512", "--num_epochs", "7", "--chunk", "512", "--lr", "5e-3",
            "--arch_width", "32", "--exp_name", "w", "--log_dir",
            str(tmp_path / "logs"), "--ckpt_dir", str(tmp_path / "ckpts"),
            "--num_sanity_val_steps", "0"]
    system = NeRFSystem(get_opts(argv), device="cpu")
    finish = system._finish_epoch

    def record(epoch, *args):
        weights[epoch] = system.models["coarse"].rgb.b.detach().clone()
        return finish(epoch, *args)

    system._finish_epoch = record
    system.fit()
    names = sorted(os.listdir(tmp_path / "ckpts" / "w"))
    assert len(names) == 5, names
    assert sorted(os.path.basename(p) for _, p in system._topk) == names
    for name in names:
        raw = checkpoints.load_checkpoint(str(tmp_path / "ckpts" / "w" / name))
        epoch = int(raw["epoch"])
        np.testing.assert_array_equal(raw["params"]["coarse"]["rgb"]["b"],
                                      weights[epoch].numpy())
