"""Checkpoint import and export against the JAX package on the CPU: one
``torch.save`` file in the reference's layout (a Lightning checkpoint of a
coarse and a fine NeRF with the reference's attribute names, after a few
``torch.optim.Adam`` steps) through both importers, for weights only and for
the full state, the decoded trees equal and each package reading the other's
output; every rejection; the port trainer resuming from an imported full
state and taking the step ``torch.optim.Adam`` takes next; the export round
trip back to torch; ``save_weights_only`` against the JAX script.
"""
import argparse
import copy
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

from nerf_pl_tpu.tools import import_torch_ckpt as jimp
from nerf_pl_tpu.training import checkpoints as jckpt
from nerf_pl_tpu_torch import import_torch_ckpt as imp_cli
from nerf_pl_tpu_torch import save_weights_only
from nerf_pl_tpu_torch.config import get_opts
from nerf_pl_tpu_torch.data.synthetic import generate_scene
from nerf_pl_tpu_torch.tools import import_torch_ckpt as imp
from nerf_pl_tpu_torch.training import checkpoints
from nerf_pl_tpu_torch.training.trainer import NeRFSystem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 32  # narrow: the layout is what is tested, not the width
LR = 5e-4


class RefNeRF(nn.Module):
    """The reference NeRF's attribute names and definition order
    (``models/nerf.py:41-123``): ``xyz_encoding_{1..8}.0``,
    ``xyz_encoding_final``, ``dir_encoding.0``, ``sigma``, ``rgb.0``."""

    def __init__(self, D=8, width=W, in_xyz=63, in_dir=27, skips=(4,)):
        super().__init__()
        for i in range(D):
            fan_in = in_xyz if i == 0 else (width + in_xyz if i in skips
                                            else width)
            setattr(self, f"xyz_encoding_{i + 1}",
                    nn.Sequential(nn.Linear(fan_in, width), nn.ReLU(True)))
        self.xyz_encoding_final = nn.Linear(width, width)
        self.dir_encoding = nn.Sequential(
            nn.Linear(width + in_dir, width // 2), nn.ReLU(True))
        self.sigma = nn.Linear(width, 1)
        self.rgb = nn.Sequential(nn.Linear(width // 2, 3), nn.Sigmoid())


def _lightning_ckpt(seed=0, steps=3, epoch=4, fine=True, **adam_kw):
    """``(checkpoint dict, models, optimizer)`` after ``steps`` Adam steps
    on random grads, saved as the reference's Lightning trainer saves it."""
    torch.manual_seed(seed)
    models = [RefNeRF()] + ([RefNeRF()] if fine else [])
    params = [p for m in models for p in m.parameters()]
    opt = torch.optim.Adam(params, lr=LR, **adam_kw)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        for p in params:
            p.grad = torch.from_numpy(
                rng.normal(scale=0.1, size=tuple(p.shape)).astype(np.float32))
        opt.step()
    sd = {}
    for name, m in zip(("nerf_coarse", "nerf_fine"), models):
        sd.update({f"{name}.{k}": v.clone() for k, v in m.state_dict().items()})
    ckpt = {"state_dict": sd,
            "optimizer_states": [copy.deepcopy(opt.state_dict())],
            "lr_schedulers": [], "epoch": epoch, "global_step": steps + 1}
    return ckpt, models, opt


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.ckpt")
    ckpt, models, opt = _lightning_ckpt()
    torch.save(ckpt, path)
    return path, ckpt, models, opt


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, a, b)
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _decoded_both_ways(path_port, path_jax):
    """Each file decoded by both packages' readers: four trees, equal."""
    trees = [checkpoints.load_checkpoint(path_port),
             checkpoints.load_checkpoint(path_jax),
             jckpt.load_checkpoint(path_port), jckpt.load_checkpoint(path_jax)]
    for t in trees[1:]:
        _assert_trees_equal(trees[0], t)
    return trees[0]


@pytest.mark.parametrize("full_state", [False, True], ids=["weights", "full"])
def test_importers_agree(ref_ckpt, tmp_path, full_state):
    path = ref_ckpt[0]
    mine, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    if full_state:
        imp.import_full_checkpoint(path, mine)
        jimp.import_full_checkpoint(path, theirs)
    else:
        imp.import_torch_checkpoint(path, mine)
        jimp.import_torch_checkpoint(path, theirs)
    tree = _decoded_both_ways(mine, theirs)
    assert sorted(tree) == (["epoch", "opt_state", "params"] if full_state
                            else ["params"])
    assert sorted(tree["params"]) == ["coarse", "fine"]
    # the weights transposed into the port's (in, out) layout
    ref = ref_ckpt[1]["state_dict"]
    np.testing.assert_array_equal(
        tree["params"]["fine"]["xyz_layers"]["4"]["w"],
        ref["nerf_fine.xyz_encoding_5.0.weight"].numpy().T)
    if full_state:
        assert tree["epoch"] == 3  # the reference's epoch 4 is the next to run
        assert sorted(tree["opt_state"]) == ["0", "1"]
        assert int(tree["opt_state"]["0"]["count"]) == 3
        assert tree["opt_state"]["1"]["count"].dtype == np.int32


def test_no_fine_model_imports_coarse_only(tmp_path):
    ckpt, _, _ = _lightning_ckpt(fine=False)
    torch.save(ckpt, str(tmp_path / "c.ckpt"))
    mine, theirs = str(tmp_path / "p.ckpt"), str(tmp_path / "j.ckpt")
    imp.import_full_checkpoint(str(tmp_path / "c.ckpt"), mine)
    jimp.import_full_checkpoint(str(tmp_path / "c.ckpt"), theirs)
    tree = _decoded_both_ways(mine, theirs)
    assert sorted(tree["params"]) == ["coarse"]


def _tamper(ckpt, how):
    """A copy of the reference checkpoint that the full-state import must
    refuse, and the message it must give."""
    ckpt = {**ckpt, "optimizer_states": [
        {"state": dict(ckpt["optimizer_states"][0]["state"]),
         "param_groups": [dict(g) for g in
                          ckpt["optimizer_states"][0]["param_groups"]]}]}
    groups = ckpt["optimizer_states"][0]["param_groups"]
    if how in ("ranger", "radam", "adamw", "sgd"):
        marker = {"ranger": "alpha", "radam": "buffer", "adamw": "warmup",
                  "sgd": "momentum"}[how]
        groups[0][marker] = 0.5
        return ckpt, f"look like the reference's '{how}' optimizer"
    if how == "not_adam":
        del groups[0]["amsgrad"]
        return ckpt, "are not a torch Adam state_dict"
    if how == "amsgrad":
        groups[0]["amsgrad"] = True
        return ckpt, "amsgrad=True Adam states"
    if how == "weight_decay_group_1":
        # the coarse and fine models in two groups, decay on the second
        ids = groups[0]["params"]
        half = len(ids) // 2
        groups[:] = [{**groups[0], "params": ids[:half]},
                     {**groups[0], "params": ids[half:], "weight_decay": 1e-4}]
        return ckpt, "param_group 1 ran with weight_decay=0.0001"
    if how == "count":
        groups[0]["params"] = groups[0]["params"] + [max(groups[0]["params"]) + 1]
        state = ckpt["optimizer_states"][0]["state"]
        state[max(groups[0]["params"])] = state[0]
        return ckpt, "optimizer state holds"
    if how == "no_optimizer_states":
        del ckpt["optimizer_states"]
        return ckpt, "carries no optimizer_states"
    if how == "two_optimizers":
        ckpt["optimizer_states"] = ckpt["optimizer_states"] * 2
        return ckpt, "expected 1 optimizer, got 2"
    raise AssertionError(how)


@pytest.mark.parametrize("how", ["ranger", "radam", "adamw", "sgd", "not_adam",
                                 "amsgrad", "weight_decay_group_1", "count",
                                 "no_optimizer_states", "two_optimizers"])
def test_full_state_rejections_match_jax(ref_ckpt, tmp_path, how):
    ckpt, msg = _tamper(ref_ckpt[1], how)
    src = str(tmp_path / "bad.ckpt")
    torch.save(ckpt, src)
    errors = []
    for fn in (imp.import_full_checkpoint, jimp.import_full_checkpoint):
        with pytest.raises((ValueError, KeyError)) as e:
            fn(src, str(tmp_path / "out.ckpt"))
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1], errors
    assert msg in errors[0][1]
    assert not (tmp_path / "out.ckpt").exists()


def test_full_state_needs_ckpt_suffix_and_safe_load(ref_ckpt, tmp_path):
    with pytest.raises(ValueError, match="must end in .ckpt"):
        imp.import_full_checkpoint(ref_ckpt[0], str(tmp_path / "out.msgpack"))
    # a corrupt file raises as itself, never as a suggestion to unpickle
    bad = tmp_path / "corrupt.ckpt"
    bad.write_bytes(b"PK\x03\x04 not a zip")
    with pytest.raises(RuntimeError) as e:
        imp.import_torch_checkpoint(str(bad), str(tmp_path / "o.ckpt"))
    assert "--allow_pickle" not in str(e.value)
    # a file the safe unpickler refuses asks for --allow_pickle, then loads
    odd = tmp_path / "odd.ckpt"
    torch.save({"state_dict": ref_ckpt[1]["state_dict"],
                "hparams": argparse.Namespace(lr=LR)}, str(odd))
    with pytest.raises(RuntimeError, match="--allow_pickle"):
        imp.import_torch_checkpoint(str(odd), str(tmp_path / "o.ckpt"))
    imp.import_torch_checkpoint(str(odd), str(tmp_path / "o.ckpt"),
                                allow_pickle=True)
    assert (tmp_path / "o.ckpt").exists()


def _scene(tmp_path):
    root = str(tmp_path / "scene")
    generate_scene(root, img_wh=16, n_train=2, n_val=1, n_test=1)
    return root


def _argv(root, tmp_path, ckpt, epochs):
    return ["--root_dir", root, "--dataset_name", "blender", "--img_wh", "16",
            "16", "--N_samples", "4", "--N_importance", "4", "--batch_size",
            "128", "--num_epochs", str(epochs), "--chunk", "256", "--lr",
            str(LR), "--arch_width", str(W), "--exp_name", "r", "--log_dir",
            str(tmp_path / "logs"), "--ckpt_dir", str(tmp_path / "ckpts"),
            "--ckpt_path", ckpt, "--num_sanity_val_steps", "0"]


def test_port_trainer_resumes_imported_state(ref_ckpt, tmp_path):
    """The imported file resumes the port trainer at the reference's next
    epoch, with its Adam moments: one step of the port's optimiser on the
    same grads as ``torch.optim.Adam``'s next step gives the same weights."""
    path, ckpt, models, _ = ref_ckpt
    out = str(tmp_path / "imported.ckpt")
    imp_cli.main(["--ckpt_path", path, "--out_path", out, "--full_state",
                  "--device", "cpu"])
    system = NeRFSystem(get_opts(_argv(_scene(tmp_path), tmp_path, out, 6)),
                        device="cpu")
    assert system.epoch0 == ckpt["epoch"]  # 3 completed -> resumes at 4
    assert system.optimizer.count == 3 and system.optimizer.sched_count == 3
    # torch's optimiser, rebuilt from the same file, takes the next step
    ref_models = [RefNeRF(), RefNeRF()]
    for name, m in zip(("nerf_coarse", "nerf_fine"), ref_models):
        m.load_state_dict({k[len(name) + 1:]: v for k, v in
                           ckpt["state_dict"].items() if k.startswith(name)})
    ref_params = [p for m in ref_models for p in m.parameters()]
    ref_opt = torch.optim.Adam(ref_params, lr=LR)
    ref_opt.load_state_dict(copy.deepcopy(ckpt["optimizer_states"][0]))
    rng = np.random.RandomState(11)
    names = {}
    for name, m in zip(("coarse", "fine"), ref_models):
        for k, p in m.named_parameters():
            names[p] = (name, k)
    port = dict(system.optimizer.params)
    for p in ref_params:
        g = rng.normal(scale=0.1, size=tuple(p.shape)).astype(np.float32)
        p.grad = torch.from_numpy(g)
        key = _port_key(*names[p])
        port[key].grad = torch.from_numpy(
            np.ascontiguousarray(g.T) if g.ndim == 2 else g.copy())
    before = [p.detach().numpy().astype(np.float64) for p in ref_params]
    ref_opt.step()
    system.optimizer.step()
    worst = 0.0
    for p, b in zip(ref_params, before):
        key = _port_key(*names[p])
        want = p.detach().numpy().astype(np.float64) - b
        got = port[key].detach().numpy().astype(np.float64)
        got = (got.T if got.ndim == 2 else got) - b
        worst = max(worst, float(np.abs(got - want).max() / LR))
    # the same Adam step: torch forms lr / bc1 * m / (sqrt(v) / sqrt(bc2) +
    # eps) with m and v updated by lerp, optax (the port's chain) m_hat /
    # (sqrt(v_hat) + eps) with m and v updated as (1 - b) g + b m.  The
    # roundings differ by a few f32 ulps of m, v and the update, and the new
    # weight rounds to its own ulp (up to 1.5e-8 at |w| ~ 0.18, 3e-5 of lr):
    # each weight's step is held to 1e-4 of the rate (the steps are ~lr)
    assert worst <= 1e-4, worst
    system.logger.close()


def _port_key(model, torch_name):
    """The port parameter name of a reference parameter name."""
    mod, leaf = torch_name.rsplit(".", 1)
    leaf = {"weight": "w", "bias": "b"}[leaf]
    if mod.startswith("xyz_encoding_") and mod != "xyz_encoding_final":
        i = int(mod.split("_")[2].split(".")[0]) - 1
        return f"{model}/xyz_layers/{i}/{leaf}"
    head = {"xyz_encoding_final": "xyz_final", "dir_encoding.0": "dir_layer",
            "sigma": "sigma", "rgb.0": "rgb"}[mod]
    return f"{model}/{head}/{leaf}"


def test_port_trainer_fits_from_imported_state(ref_ckpt, tmp_path):
    path = ref_ckpt[0]
    out = str(tmp_path / "imported.ckpt")
    imp.import_full_checkpoint(path, out)
    system = NeRFSystem(get_opts(_argv(_scene(tmp_path), tmp_path, out, 6)),
                        device="cpu")
    system.fit()  # epochs 4 and 5
    assert sorted(os.listdir(tmp_path / "ckpts" / "r")) == ["epoch=4.ckpt",
                                                            "epoch=5.ckpt"]
    raw = checkpoints.load_checkpoint(str(tmp_path / "ckpts" / "r" / "epoch=5.ckpt"))
    # the Adam count went on from the reference's 3 steps
    spe = system.steps_per_epoch
    assert int(raw["opt_state"]["0"]["count"]) == 3 + 2 * spe


def test_export_round_trip(ref_ckpt, tmp_path):
    """reference -> port (full state) -> reference: the state_dict and the
    Adam moments come back bit for bit, and torch's Adam loads them."""
    path, ckpt, _, _ = ref_ckpt
    ours = str(tmp_path / "ours.ckpt")
    imp.import_full_checkpoint(path, ours)
    back, jback = str(tmp_path / "back.ckpt"), str(tmp_path / "jback.ckpt")
    imp_cli.main(["--ckpt_path", ours, "--out_path", back, "--export",
                  "--full_state", "--lr", str(LR), "--device", "cpu"])
    jimp.export_full_checkpoint(ours, jback, lr=LR)
    got = torch.load(back, weights_only=True)
    theirs = torch.load(jback, weights_only=True)
    for k, v in ckpt["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
        assert torch.equal(theirs["state_dict"][k], v), k
    assert got["epoch"] == ckpt["epoch"] == theirs["epoch"]
    assert got["global_step"] == theirs["global_step"] == 4
    ref_state = ckpt["optimizer_states"][0]["state"]
    for i, st in got["optimizer_states"][0]["state"].items():
        assert int(st["step"]) == int(ref_state[i]["step"])
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[m], ref_state[i][m]), (i, m)
            assert torch.equal(theirs["optimizer_states"][0]["state"][i][m],
                               st[m])
    params = [p for m in (RefNeRF(), RefNeRF()) for p in m.parameters()]
    fresh = torch.optim.Adam(params, lr=LR)
    fresh.load_state_dict(got["optimizer_states"][0])
    for p, i in zip(params, range(len(params))):
        assert torch.equal(fresh.state[p]["exp_avg"], ref_state[i]["exp_avg"])
    # weights only: the plain export
    imp.export_torch_checkpoint(ours, str(tmp_path / "w.ckpt"))
    w = torch.load(str(tmp_path / "w.ckpt"), weights_only=True)
    assert sorted(w) == ["state_dict"]
    for k, v in ckpt["state_dict"].items():
        assert torch.equal(w["state_dict"][k], v), k
    wonly = save_weights_only.main(["--ckpt_path", ours, "--device", "cpu"])
    with pytest.raises(KeyError, match="weights-only"):
        imp.export_full_checkpoint(wonly, str(tmp_path / "x.ckpt"))


def test_save_weights_only_never_overwrites_input(ref_ckpt, tmp_path):
    ours = str(tmp_path / "full.ckpt")
    imp.import_full_checkpoint(ref_ckpt[0], ours)
    src = str(tmp_path / "last")  # no .ckpt suffix
    shutil.copy(ours, src)
    before = open(src, "rb").read()
    out = save_weights_only.main(["--ckpt_path", src, "--device", "cpu"])
    assert out == str(tmp_path / "last_weights.ckpt")
    assert open(src, "rb").read() == before, "input checkpoint was clobbered"
    state = checkpoints.load_checkpoint(out)
    assert sorted(state) == ["params"]
    _assert_trees_equal(state["params"], checkpoints.load_checkpoint(src)["params"])
    # the JAX script on the same input writes the same tree (its reader
    # returns the keys sorted, so the bytes differ in the order of keys)
    r = subprocess.run(
        [sys.executable, "save_weights_only.py", "--ckpt_path", ours,
         "--out_path", str(tmp_path / "jax_weights.ckpt")],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ""})
    assert r.returncode == 0, r.stderr[-500:]
    save_weights_only.main(["--ckpt_path", ours, "--out_path",
                            str(tmp_path / "port_weights.ckpt"), "--device",
                            "cpu"])
    _decoded_both_ways(str(tmp_path / "port_weights.ckpt"),
                       str(tmp_path / "jax_weights.ckpt"))


def test_clis_default_to_cuda(ref_ckpt, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        imp_cli.main(["--ckpt_path", ref_ckpt[0], "--out_path",
                      str(tmp_path / "o.ckpt")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        save_weights_only.main(["--ckpt_path", ref_ckpt[0]])
    assert not os.listdir(tmp_path)
