"""Test-set evaluation against the JAX package on the CPU: the LANCZOS
resize against PIL, PFM files both ways, the GIF writer against imageio's,
and ``python -m nerf_pl_tpu_torch.eval`` against the JAX tool on a
checkpoint in the JAX trainer's file format.
"""
import argparse
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_pl_tpu.data import depth_utils as jdepth
from nerf_pl_tpu.tools import evaluate as jeval
from nerf_pl_tpu.training import checkpoints as jckpt
from nerf_pl_tpu_torch.data import depth_utils, png
from nerf_pl_tpu_torch.data.resize import resize_lanczos
from nerf_pl_tpu_torch.eval import main as eval_main
from nerf_pl_tpu_torch.ops import fused_mlp
from nerf_pl_tpu_torch.tools import evaluate
from nerf_pl_tpu_torch.utils.gif import write_gif

from test_torch_port_models import np_nerf


# ------------------------------------------------------------------ LANCZOS
def _image(seed, size, mode):
    """A smooth image with noise, and for alpha modes a disc of opacity with
    a half-transparent band, so the premultiplied path is exercised."""
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = np.stack([np.sin(6 * xx + 2 * yy + k) * 0.5 + 0.5 for k in range(c)], -1)
    img = np.clip(base * 255 + rng.randint(-40, 40, base.shape), 0, 255).astype(np.uint8)
    if mode in ("LA", "RGBA"):
        r = (xx - 0.5) ** 2 + (yy - 0.5) ** 2
        img[..., -1][r > 0.12] = 0
        img[..., -1][(r > 0.08) & (r <= 0.12)] = 128
    return img[..., 0] if c == 1 else img


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "LA", "L"])
@pytest.mark.parametrize("sizes", [(800, 400), (100, 37), (37, 100)],
                         ids=["800to400", "100to37", "up37to100"])
def test_lanczos_matches_pil(mode, sizes):
    src, dst = sizes
    img = _image(src + dst, src, mode)
    ref = np.asarray(Image.fromarray(img, mode).resize((dst, dst), Image.LANCZOS))
    out = resize_lanczos(img, mode, (dst, dst))
    assert out.shape == ref.shape and out.dtype == np.uint8
    # PIL's fixed-point arithmetic repeated step for step: at most 1 level of
    # 255 is allowed (a double weight rounding the other way at a .5 of the
    # 22-bit scale); Pillow 12.1 and this code agree to the bit
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_lanczos_black_and_white_path_matches_pil():
    """The loader's black-and-white branch resizes first and takes PIL's
    luma after (nerf_pl_tpu/data/blender.py:36-45)."""
    img = _image(5, 100, "RGBA")
    pil = Image.fromarray(img, "RGBA").resize((37, 37), Image.LANCZOS)
    out = resize_lanczos(img, "RGBA", (37, 37))
    assert np.abs(png.to_luma(out, "RGBA").astype(int)
                  - np.asarray(pil.convert("L")).astype(int)).max() <= 1
    assert np.abs(out[..., 3].astype(int) - np.asarray(pil)[..., 3]).max() <= 1
    # non-square, and the same size (PIL copies without resampling)
    wide = img[:, :60]
    np.testing.assert_array_equal(
        resize_lanczos(wide, "RGBA", (17, 41)),
        np.asarray(Image.fromarray(wide, "RGBA").resize((17, 41), Image.LANCZOS)))
    np.testing.assert_array_equal(resize_lanczos(img, "RGBA", (100, 100)), img)


# ---------------------------------------------------------------------- PFM
@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3)], ids=["gray", "colour"])
def test_pfm_both_ways(tmp_path, shape):
    data = np.random.RandomState(1).normal(size=shape).astype(np.float32)
    depth_utils.save_pfm(str(tmp_path / "port.pfm"), data, scale=2.0)
    jdepth.save_pfm(str(tmp_path / "jax.pfm"), data, scale=2.0)
    assert (tmp_path / "port.pfm").read_bytes() == (tmp_path / "jax.pfm").read_bytes()
    for read in (depth_utils.read_pfm, jdepth.read_pfm):
        for name in ("port.pfm", "jax.pfm"):
            back, scale = read(str(tmp_path / name))
            np.testing.assert_array_equal(back, data)
            assert scale == 2.0
    with pytest.raises(ValueError, match="float32"):
        depth_utils.save_pfm(str(tmp_path / "x.pfm"), data.astype(np.float64))
    (tmp_path / "bad.pfm").write_bytes(b"P6\n")
    with pytest.raises(ValueError, match="Not a PFM"):
        depth_utils.read_pfm(str(tmp_path / "bad.pfm"))


# ---------------------------------------------------------------------- GIF
def _frames(kind):
    rng = np.random.RandomState(2)
    if kind == "few_colours":
        return [(rng.randint(0, 5, (40, 30, 3)) * 60).astype(np.uint8) for _ in range(3)]
    yy, xx = np.mgrid[0:120, 0:160] / 160
    return [(np.stack([np.sin(3 * xx + k) * 0.5 + 0.5, yy, (xx * yy + k / 5) % 1], -1)
             * 255).astype(np.uint8) for k in range(4)]


def _read_gif(path):
    im = Image.open(path)
    frames, delays = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")).astype(int))
        delays.append(im.info.get("duration"))
    return frames, delays, im.info.get("loop")


@pytest.mark.parametrize("kind", ["few_colours", "smooth"])
def test_gif_matches_imageio_timing(tmp_path, kind):
    frames = _frames(kind)
    write_gif(str(tmp_path / "port.gif"), frames, fps=30)
    imageio.mimsave(str(tmp_path / "ref.gif"), frames, fps=30)
    got, delays, loop = _read_gif(tmp_path / "port.gif")
    ref, ref_delays, ref_loop = _read_gif(tmp_path / "ref.gif")
    assert len(got) == len(ref) == len(frames)
    assert delays == ref_delays and loop == ref_loop
    for a, src in zip(got, frames):
        err = np.abs(a - src)
        if kind == "few_colours":
            assert err.max() == 0  # at most 256 colours: stored exactly
        else:
            # median cut to 256 colours from ~18k: 19 levels at most and 3.4
            # on average here
            assert err.max() <= 24 and err.mean() <= 4.0, (err.max(), err.mean())
    with pytest.raises(ValueError, match="frames"):
        write_gif(str(tmp_path / "x.gif"), [frames[0], frames[0][:10]])


# ------------------------------------------------------------ eval vs JAX
def test_get_opts_match_jax():
    mine = evaluate.get_opts(["--root_dir", "r", "--ckpt_path", "c"])
    ref = jeval.get_opts(["--root_dir", "r", "--ckpt_path", "c"])
    assert mine.device == "cuda"
    assert {k: v for k, v in vars(mine).items() if k != "device"} == vars(ref)
    argv = ["--root_dir", "/x", "--ckpt_path", "/c.ckpt", "--img_wh", "400", "400",
            "--N_importance", "0", "--chunk", "4096", "--save_depth",
            "--depth_format", "bytes", "--white_back", "true",
            "--fused_channel_io", "false", "--eval_window", "1",
            "--blender_near", "1", "--blender_far", "12", "--split", "val",
            "--use_disp", "--spheric_poses", "--scene_name", "s"]
    mine, ref = evaluate.get_opts(argv + ["--device", "cpu"]), jeval.get_opts(argv)
    assert {k: v for k, v in vars(mine).items() if k != "device"} == vars(ref)
    assert mine.device == "cpu" and mine.fused_channel_io is False


def _eval_argv(root, ckpt, out, extra=()):
    return ["--root_dir", root, "--ckpt_path", ckpt, "--img_wh", "16", "16",
            "--N_samples", "8", "--N_importance", "8", "--chunk", "100",
            "--blender_near", "1", "--blender_far", "12", "--white_back", "true",
            "--save_depth", "--out_dir", str(out), *extra]


@pytest.mark.parametrize("fine", [True, False], ids=["coarse_fine", "coarse_only"])
def test_eval_matches_jax(blender_root, tmp_path, capsys, fine):
    """``python -m nerf_pl_tpu_torch.eval`` against the JAX tool on a
    checkpoint in the JAX trainer's format (params, opt_state, epoch): the
    same files, PNGs within 1 level, PSNR within 0.01 dB, depth as close as
    JAX is to itself; a coarse-only checkpoint takes the same fallback."""
    params = {"coarse": np_nerf(70)}
    if fine:
        params["fine"] = np_nerf(71)
    for tree in params.values():  # a partly opaque random scene
        tree["sigma"]["w"] *= 40.0
    ckpt = str(tmp_path / "epoch=0.ckpt")
    jckpt.save_checkpoint(ckpt, {"params": params, "opt_state": [], "epoch": 0})

    ref_psnr = jeval.run(jeval.get_opts(_eval_argv(blender_root, ckpt, tmp_path / "jax")))
    ref_out = capsys.readouterr().out
    launches = {k: fn.launches for k, fn in fused_mlp.KERNELS.items()}
    psnr = eval_main(_eval_argv(blender_root, ckpt, tmp_path / "port",
                                ("--device", "cpu", "--eval_window", "1")))
    out = capsys.readouterr().out
    assert launches == {k: fn.launches for k, fn in fused_mlp.KERNELS.items()}
    fallback = "[eval] checkpoint has no fine model — rendering coarse-only"
    assert (fallback in out) == (fallback in ref_out) == (not fine)
    assert f"Mean PSNR : {psnr:.2f}" in out
    assert abs(psnr - ref_psnr) <= 0.01, (psnr, ref_psnr)

    mine_dir = tmp_path / "port" / "blender" / "test"
    ref_dir = tmp_path / "jax" / "blender" / "test"
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(mine_dir)) == names
    assert names == ["000.png", "001.png", "depth_000.pfm", "depth_001.pfm", "test.gif"]
    for name in names:
        if name.endswith(".png"):
            a, mode = png.read_png(str(mine_dir / name))
            b = np.asarray(Image.open(ref_dir / name))
            assert mode == "RGB" and a.shape == b.shape == (16, 16, 3)
            # f32 on the CPU, sums in another order: one level at a rounding edge
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        elif name.endswith(".pfm"):
            a, _ = depth_utils.read_pfm(str(mine_dir / name))
            b, _ = jdepth.read_pfm(str(ref_dir / name))
            # a knife-edge importance sample moves a ray's depth: JAX's own
            # eager and jitted renders of this scene differ by 7.6e-3 (of 12),
            # the port and the jitted JAX tool by 9.7e-3
            np.testing.assert_allclose(a, b, atol=2e-2, rtol=0)
    got, delays, _ = _read_gif(mine_dir / "test.gif")
    ref, ref_delays, _ = _read_gif(ref_dir / "test.gif")
    assert len(got) == len(ref) == 2 and delays == ref_delays


def test_eval_refuses_unported_datasets_and_defaults_to_cuda(tmp_path, monkeypatch):
    """``--dataset_name llff``, once refused, renders (the spiral and the
    training poses are held against the JAX tool in
    tests/test_torch_port_llff.py); without a card the tool still refuses
    the default ``cuda``."""
    from nerf_pl_tpu_torch.data.synthetic import generate_llff_scene

    root = generate_llff_scene(str(tmp_path / "llff"), img_wh=(8, 6),
                               n_views=3)
    ckpt = str(tmp_path / "epoch=0.ckpt")
    jckpt.save_checkpoint(ckpt, {"params": {"coarse": np_nerf(72)},
                                 "opt_state": [], "epoch": 0})
    args = evaluate.get_opts(["--root_dir", root, "--ckpt_path", ckpt,
                              "--dataset_name", "llff", "--img_wh", "8", "6",
                              "--N_samples", "4", "--split", "test_train",
                              "--out_dir", str(tmp_path / "out"),
                              "--device", "cpu"])
    assert evaluate.run(args) is None  # no ground truth, no PSNR
    out = sorted(os.listdir(tmp_path / "out" / "llff" / "test"))
    assert out == ["000.png", "001.png", "002.png", "test.gif"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.run(argparse.Namespace(**{**vars(args), "device": "cuda"}))
