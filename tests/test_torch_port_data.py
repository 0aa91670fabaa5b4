"""The port's training data and trainer against the JAX package on the CPU: the PNG
codec against PIL, ``BlenderDataset`` against the JAX loader, and the
training CLI on the conftest scene, with checkpoints moving both ways.
"""
import json
import os
import signal
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_pl_tpu.data.blender import BlenderDataset as JaxBlender
from nerf_pl_tpu.training import checkpoints as jckpt
from nerf_pl_tpu.training import optim as joptim
from nerf_pl_tpu_torch.config import get_opts
from nerf_pl_tpu_torch.data import png
from nerf_pl_tpu_torch.data.image import Picture, convert
from nerf_pl_tpu_torch.data.blender import BlenderDataset
from nerf_pl_tpu_torch.models.nerf import nerf_to_numpy
from nerf_pl_tpu_torch.train import main as train_main
from nerf_pl_tpu_torch.training.trainer import NeRFSystem

from test_torch_port_models import np_nerf

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _encode(img, ftype, ctype):
    """A PNG whose every scanline uses filter ``ftype`` (0-4)."""
    h, w, c = img.shape
    a = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        up = a[y - 1] if y else np.zeros(w * c, np.int32)
        out = np.zeros(w * c, np.int32)
        for x in range(w * c):
            left = a[y, x - c] if x >= c else 0
            ul = up[x - c] if x >= c else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = left
            elif ftype == 2:
                pred = up[x]
            elif ftype == 3:
                pred = (left + up[x]) >> 1
            else:
                p = left + up[x] - ul
                pa, pb, pc = abs(p - left), abs(p - up[x]), abs(p - ul)
                pred = left if pa <= pb and pa <= pc else (up[x] if pb <= pc else ul)
            out[x] = (a[y, x] - pred) & 0xFF
        rows.append(bytes([ftype]) + out.astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


# ---------------------------------------------------------------------- PNG
@pytest.mark.parametrize("mode", sorted(MODES))
def test_png_filters_and_writer(tmp_path, mode):
    c = MODES[mode]
    img = (np.random.RandomState(c).rand(7, 9, c) * 255).astype(np.uint8)
    img[:3] = np.arange(9, dtype=np.uint8)[None, :, None] * 20  # smooth rows
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    want = img[..., 0] if c == 1 else img
    for ftype in range(5):
        path = tmp_path / f"f{ftype}.png"
        path.write_bytes(_encode(img, ftype, ctype))
        arr, got_mode = png.read_png(str(path))
        assert got_mode == mode
        np.testing.assert_array_equal(arr, want)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    out = tmp_path / "w.png"
    png.write_png(str(out), want)
    assert Image.open(out).mode == mode
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want)
    # PIL's own adaptive-filter files
    Image.fromarray(want, mode).save(tmp_path / "pil.png", optimize=True)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "pil.png"))[0], want)


def test_png_reads_the_conftest_scene_as_pil(blender_root):
    for split in ("train", "val", "test"):
        for name in sorted(os.listdir(os.path.join(blender_root, split))):
            path = os.path.join(blender_root, split, name)
            arr, mode = png.read_png(path)
            ref = Image.open(path)
            assert mode == ref.mode
            np.testing.assert_array_equal(arr, np.asarray(ref))
            pic = Picture(arr, mode)
            np.testing.assert_array_equal(convert(pic, "L"),
                                          np.asarray(ref.convert("L")))
            np.testing.assert_array_equal(convert(pic, "RGBA"),
                                          np.asarray(ref.convert("RGBA")))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_luma_and_rgba_match_pil(mode):
    c = MODES[mode]
    img = (np.random.RandomState(10 + c).rand(32, 32, c) * 256).astype(np.uint8)
    img = img[..., 0] if c == 1 else img
    pil = Image.fromarray(img, mode)
    np.testing.assert_array_equal(convert(Picture(img, mode), "L"),
                                  np.asarray(pil.convert("L")))
    np.testing.assert_array_equal(convert(Picture(img, mode), "RGBA"),
                                  np.asarray(pil.convert("RGBA")))


def test_png_refuses_what_it_cannot_read(tmp_path):
    """16-bit, palette and interlaced PNGs are read now, as Pillow reads
    them; what Pillow cannot open (a bit depth its ``_MODES`` lacks, or
    other content) still raises, naming the file."""
    import image_writers

    Image.fromarray(np.arange(16, dtype=np.uint16).reshape(4, 4) * 4000,
                    "I;16").save(tmp_path / "d16.png")
    Image.fromarray(np.arange(16, dtype=np.uint8).reshape(4, 4),
                    "L").convert("P").save(tmp_path / "p.png")
    (tmp_path / "i.png").write_bytes(image_writers.png_bytes(
        np.arange(12, dtype=np.uint8).reshape(2, 2, 3) * 20, 8, 2,
        interlace=True))
    for name, mode in (("d16", "I;16"), ("p", "P"), ("i", "RGB")):
        arr, got_mode = png.read_png(str(tmp_path / f"{name}.png"))
        pil = Image.open(tmp_path / f"{name}.png")
        assert got_mode == pil.mode == mode
        np.testing.assert_array_equal(arr, np.asarray(pil))
    deep = bytearray(_encode(np.zeros((2, 2, 3), np.uint8), 0, 2))
    deep[24] = 4  # IHDR's bit depth: 4-bit RGB is no PNG layout
    deep[29:33] = struct.pack(">I", zlib.crc32(bytes(deep[12:29])))
    (tmp_path / "deep.png").write_bytes(bytes(deep))
    (tmp_path / "x.png").write_bytes(b"not a png")
    for name, match in (("deep", r"deep\.png: unsupported PNG \(bit depth 4"),
                        ("x", r"x\.png: not a PNG")):
        with pytest.raises(ValueError, match=match):
            png.read_png(str(tmp_path / f"{name}.png"))


# ------------------------------------------------------------------ Blender
@pytest.mark.parametrize("bw", [False, True], ids=["rgb", "black_and_white"])
def test_blender_dataset_matches_jax(blender_root, bw):
    kw = dict(img_wh=(16, 16), near=1.0, far=12.0, black_and_white=bw)
    mine, ref = BlenderDataset(blender_root, "train", **kw), JaxBlender(blender_root, "train", **kw)
    # the same numpy arithmetic on the same pixels: bit-equal
    np.testing.assert_array_equal(mine.all_rays, ref.all_rays)
    np.testing.assert_array_equal(mine.all_rgbs, ref.all_rgbs)
    assert len(mine) == len(ref) and mine.white_back == ref.white_back
    val, jval = BlenderDataset(blender_root, "val", **kw), JaxBlender(blender_root, "val", **kw)
    assert len(val) == len(jval) == 2
    for i in range(2):
        a, b = val[i], jval[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("bw", [False, True], ids=["rgb", "black_and_white"])
def test_blender_size_mismatch_raises(blender_root, bw):
    """A size other than the PNGs' no longer raises: the port resizes with
    its numpy LANCZOS, bit-equal to the JAX loader's PIL resize."""
    for wh in ((8, 8), (37, 37)):
        kw = dict(img_wh=wh, near=1.0, far=12.0, black_and_white=bw)
        mine = BlenderDataset(blender_root, "train", **kw)
        ref = JaxBlender(blender_root, "train", **kw)
        np.testing.assert_array_equal(mine.all_rgbs, ref.all_rgbs)
        np.testing.assert_array_equal(mine.all_rays, ref.all_rays)
        np.testing.assert_array_equal(BlenderDataset(blender_root, "val", **kw)[1]["rgbs"],
                                      JaxBlender(blender_root, "val", **kw)[1]["rgbs"])


# -------------------------------------------------------------- CLI, ckpts
def _argv(root, tmp, epochs=2, extra=()):
    return ["--root_dir", root, "--dataset_name", "blender", "--img_wh", "16", "16",
            "--N_samples", "8", "--N_importance", "8", "--batch_size", "128",
            "--num_epochs", str(epochs), "--chunk", "256", "--lr", "5e-3",
            "--blender_near", "1", "--blender_far", "12", "--white_back", "true",
            "--exp_name", "t", "--log_dir", str(tmp / "logs"),
            "--ckpt_dir", str(tmp / "ckpts"), *extra]


CPU = ["--device", "cpu"]


def test_cli_trains_and_jax_reads_its_checkpoints(blender_root, tmp_path, capsys):
    system = train_main(_argv(blender_root, tmp_path) + CPU)
    printed = capsys.readouterr().out
    assert "[sanity]" in printed and "epoch 0:" in printed and "epoch 1:" in printed
    with open(tmp_path / "logs" / "t" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train/loss" in r]
    assert len(train) == 2 and train[1]["train/loss"] < train[0]["train/loss"]
    assert {"lr", "train/psnr", "train/rays_per_s"} <= set(train[0])
    assert any("val/psnr" in r for r in recs)
    assert os.path.exists(tmp_path / "logs" / "t" / "config.json")
    path = str(tmp_path / "ckpts" / "t" / "epoch=1.ckpt")
    assert sorted(os.listdir(tmp_path / "ckpts" / "t")) == ["epoch=0.ckpt", "epoch=1.ckpt"]
    # the JAX package restores it into its own trainer's state layout
    params = {"coarse": np_nerf(0), "fine": np_nerf(1)}
    sched = joptim.make_lr_schedule(5e-3, "steplr", system.steps_per_epoch, 2)
    opt_state = joptim.get_optimizer("adam", sched).init(params)
    state = jckpt.load_checkpoint(path, {"params": params, "opt_state": opt_state, "epoch": 0})
    assert int(state["epoch"]) == 1
    assert int(state["opt_state"][0].count) == 2 * system.steps_per_epoch
    assert int(state["opt_state"][1].count) == 2 * system.steps_per_epoch
    mine = nerf_to_numpy(system.models["fine"])
    np.testing.assert_array_equal(np.asarray(state["params"]["fine"]["xyz_layers"][3]["w"]),
                                  mine["xyz_layers"][3]["w"])
    np.testing.assert_array_equal(
        np.asarray(state["opt_state"][0].nu["coarse"]["rgb"]["w"]),
        system.optimizer.nu["coarse/rgb/w"].numpy())


def test_jax_checkpoint_resumes_in_the_port(blender_root, tmp_path, capsys):
    params = {"coarse": np_nerf(2), "fine": np_nerf(3)}
    opt = joptim.get_optimizer("adam", joptim.make_lr_schedule(5e-3, "steplr", 6, 2))
    state = opt.init(params)
    grads = jax.tree_util.tree_map(lambda a: jnp.full(a.shape, 1e-3, jnp.float32), params)
    _, state = opt.update(grads, state, params)
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, {"params": params, "opt_state": state, "epoch": 0})
    cfg_argv = _argv(blender_root, tmp_path, extra=("--ckpt_path", path))
    system = train_main(cfg_argv + CPU)
    printed = capsys.readouterr().out
    assert "epoch 0:" not in printed and "epoch 1:" in printed
    assert system.epoch0 == 1
    # one JAX step plus this epoch's steps
    assert system.optimizer.count == 1 + system.steps_per_epoch
    # the resumed state is the JAX one: rebuild without fitting and compare
    resumed = NeRFSystem(get_opts(cfg_argv), device="cpu")
    np.testing.assert_array_equal(resumed.optimizer.mu["fine/sigma/w"].numpy(),
                                  np.asarray(state[0].mu["fine"]["sigma"]["w"]))
    np.testing.assert_array_equal(nerf_to_numpy(resumed.models["coarse"])["rgb"]["b"],
                                  params["coarse"]["rgb"]["b"])


def test_sigterm_saves_an_incomplete_epoch_as_the_one_before(blender_root, tmp_path):
    class Stop(Exception):
        pass

    def stop(signum, frame):
        raise Stop

    prev = signal.signal(signal.SIGTERM, stop)
    try:
        system = NeRFSystem(get_opts(_argv(blender_root, tmp_path)), device="cpu")
        system.cfg.num_sanity_val_steps = 0
        system._preempted = True  # as if SIGTERM arrived before the first step
        with pytest.raises(Stop):
            system.fit()
        assert signal.getsignal(signal.SIGTERM) is stop  # restored
    finally:
        signal.signal(signal.SIGTERM, prev)
    saved = jckpt.load_checkpoint(str(tmp_path / "ckpts" / "t" / "preempt.ckpt"))
    assert int(saved["epoch"]) == -1  # epoch 0 incomplete: resume re-runs it


def test_fit_takes_the_batches_in_the_same_order(blender_root, tmp_path):
    # the epoch's permutation moves to the device once; each step's batch is
    # still rows perm[i B:(i + 1) B] of a fresh permutation from the
    # trainer's CPU generator, epoch after epoch
    system = NeRFSystem(get_opts(_argv(blender_root, tmp_path, epochs=3)),
                        device="cpu")
    system.cfg.num_sanity_val_steps = 0
    seen = []

    def step(rays, rgbs):
        seen.append((rays.clone(), rgbs.clone()))
        return torch.zeros(()), torch.zeros(())

    system.train_step = step
    system._finish_epoch = lambda *args: None
    system.fit()
    gen = torch.Generator().manual_seed(system.cfg.seed)
    B, n = system.cfg.batch_size, system.rays.shape[0]
    want = []
    for _ in range(3):
        perm = torch.randperm(n, generator=gen)
        for i in range(system.steps_per_epoch):
            idx = perm[i * B:(i + 1) * B]
            want.append((system.rays[idx], system.rgbs[idx]))
    assert len(seen) == len(want) == 3 * system.steps_per_epoch
    for (r, c), (wr, wc) in zip(seen, want):
        assert torch.equal(r, wr) and torch.equal(c, wc)


def test_trainer_refuses_flags_it_cannot_honour(blender_root, tmp_path):
    # a world of several ranks is made by the launcher (or torchrun), not by
    # one process; a negative slab would make a streaming epoch empty
    with pytest.raises(ValueError, match="one process per device"):
        NeRFSystem(get_opts(_argv(blender_root, tmp_path)
                            + ["--num_devices", "2"]), device="cpu")
    with pytest.raises(ValueError, match="must be positive"):
        NeRFSystem(get_opts(_argv(blender_root, tmp_path) + [
            "--data_device_resident", "false", "--stream_slab_steps", "-1"]),
            device="cpu")
    # ported since: distribution and streaming (tests/test_torch_port_
    # distributed.py, _sharding.py, _raystore.py); in one process
    # --multihost without a group and --per_host_data are no-ops, as in JAX
    for extra in (["--multihost"], ["--per_host_data"],
                  ["--data_device_resident", "false"], ["--global_reshuffle"]):
        system = NeRFSystem(get_opts(_argv(blender_root, tmp_path) + extra),
                            device="cpu")
        assert system.mesh.size == 1 and not system.mesh.distributed
        assert (system.ray_store is not None) == ("false" in extra)
        system.logger.close()
    # ported since: the other optimisers and schedules (and the llff loader,
    # tests/test_torch_port_llff.py) build where they were refused
    for extra, kind in ((["--optimizer", "radam"], "RAdam"),
                        (["--lr_scheduler", "cosine"], "Adam"),
                        (["--optimizer", "ranger", "--lr_scheduler", "poly"],
                         "Ranger")):
        system = NeRFSystem(get_opts(_argv(blender_root, tmp_path) + extra),
                            device="cpu")
        assert type(system.optimizer).__name__ == kind
        assert system.schedule(system.steps_per_epoch) < 5e-3
        system.logger.close()


def test_cli_defaults_to_cuda(blender_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(_argv(blender_root, tmp_path))


def test_cli_trains_with_row_major_fused_io(blender_root, tmp_path):
    """``--fused_channel_io false`` runs the fit through the row-major fused
    MLP (D' and E' plain on the CPU).  Its kernels give the channel-major
    ones' bits, but the renderer reads their outputs as views of another
    memory order, so its sums over the samples run in another order: the
    epoch-0 loss agrees to rounding carried through the bf16 steps."""
    losses = {}
    for io in ("true", "false"):
        argv = _argv(blender_root, tmp_path / io, epochs=1,
                     extra=("--compute_dtype", "bfloat16",
                            "--fused_channel_io", io))
        system = train_main(argv + CPU)
        assert system.rkw["use_fused"] and system.rkw["fused_channel_io"] == (io == "true")
        with open(tmp_path / io / "logs" / "t" / "metrics.jsonl") as f:
            losses[io] = [json.loads(line)["train/loss"] for line in f
                          if "train/loss" in line][0]
    rel = abs(losses["false"] - losses["true"]) / losses["true"]
    # 6 steps at full width: 1.4e-5 on the CPU
    assert np.isfinite(losses["false"]) and rel <= 1e-3, rel
