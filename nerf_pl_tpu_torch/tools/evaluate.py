"""Test-set evaluation: render every test pose, save PNGs (and optional
depth PFM or raw bytes), write a GIF, report the mean PSNR
(``nerf_pl_tpu/tools/evaluate.py``; reference ``eval.py``).

As the JAX tool: ``test_time=True`` rendering with perturb and noise off, in
float32; depth ``nan_to_num`` before saving; the GIF at 30 fps; PSNR only
for splits with ground truth; ``--chunk`` honoured.  ``--dataset_name llff``
renders ``test`` (the 120-pose spiral, or the circle with
``--spheric_poses``) or ``test_train`` (the training poses); neither has
ground truth in the loader, so neither prints a PSNR, as in JAX.  The fused MLP runs on
the card (kernels C or, with ``--fused_channel_io false``, C'), as the JAX
tool runs it on the TPU; on the CPU the renderer takes ``posenc`` + NeRF,
as JAX does off the TPU.  PNGs, PFMs and the GIF are written with the
port's own codecs (``data/png.py``, ``data/depth_utils.py``,
``utils/gif.py``).
"""
from __future__ import annotations

import argparse
import os
from collections import deque
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..data import dataset_dict
from ..data.depth_utils import save_pfm
from ..data.png import write_png
from ..models.nerf import init_nerf
from ..training.checkpoints import extract_model_state_dict, load_ckpt_into
from ..training.metrics import psnr as psnr_metric
from ..utils.gif import write_gif
from .render import render_image

# frames kept in flight by the eval loop (1 = fully serial)
EVAL_WINDOW = 3


def get_opts(argv=None):
    """The JAX tool's flags, field for field, and ``--device``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--dataset_name", type=str, default="blender",
                        choices=["blender", "llff"])
    parser.add_argument("--scene_name", type=str, default="test")
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--img_wh", nargs="+", type=int, default=[800, 800])
    parser.add_argument("--spheric_poses", default=False, action="store_true")
    parser.add_argument("--N_samples", type=int, default=64)
    parser.add_argument("--N_importance", type=int, default=128)
    parser.add_argument("--use_disp", default=False, action="store_true")
    parser.add_argument("--chunk", type=int, default=32 * 1024)
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--save_depth", default=False, action="store_true")
    parser.add_argument("--depth_format", type=str, default="pfm",
                        choices=["pfm", "bytes"])
    parser.add_argument("--out_dir", type=str, default="results")
    parser.add_argument("--blender_near", type=float, default=2.0)
    parser.add_argument("--blender_far", type=float, default=6.0)
    parser.add_argument("--white_back", type=lambda s: s.lower() == "true",
                        default=None)
    parser.add_argument("--fused_channel_io",
                        type=lambda v: v.lower() == "true", default=True,
                        help="channel-major (8, P) ray IO at the fused MLP "
                             "(kernel C); false takes the row-major kernel C'")
    parser.add_argument("--eval_window", type=int, default=None,
                        help="frames kept in flight by the eval loop "
                             "(default 3; 1 = fully serial)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def _width_of(state: dict) -> int:
    # --arch_width checkpoints carry their width in the weight shapes
    # (trunk layer 0 is (in_xyz, W)); 256 when absent
    w = state.get("xyz_layers/0/w")
    return int(w.shape[1]) if w is not None else 256


def load_models(ckpt_path: str, device=None) -> dict:
    """``{"coarse": NeRF, "fine": NeRF}`` from a checkpoint.  A checkpoint
    trained with N_importance=0 has no fine weights: then ``"fine"`` is
    omitted rather than substituted by a randomly initialised network."""
    device = resolve_device(device)
    models = {}
    for seed, name in enumerate(("coarse", "fine")):
        state = extract_model_state_dict(ckpt_path, name)
        if name == "fine" and not state:
            break
        gen = torch.Generator().manual_seed(seed)
        model = init_nerf(gen, W=_width_of(state), device="cpu")
        load_ckpt_into(model, ckpt_path, name, loaded=state)
        models[name] = model.to(device).requires_grad_(False)
    return models


def run(args) -> Optional[float]:
    """Render the split, write the files; the mean PSNR, or None without
    ground truth."""
    device = resolve_device(args.device)
    w, h = args.img_wh
    kwargs = dict(root_dir=args.root_dir, split=args.split,
                  img_wh=tuple(args.img_wh))
    if args.dataset_name == "llff":
        kwargs["spheric_poses"] = args.spheric_poses
    else:
        kwargs.update(near=args.blender_near, far=args.blender_far,
                      white_back=args.white_back)
    dataset = dataset_dict[args.dataset_name](**kwargs)

    models = load_models(args.ckpt_path, device)
    if "fine" not in models and args.N_importance > 0:
        print("[eval] checkpoint has no fine model — rendering coarse-only")
        args.N_importance = 0

    imgs, psnrs = [], []
    dir_name = os.path.join(args.out_dir, args.dataset_name, args.scene_name)
    os.makedirs(dir_name, exist_ok=True)

    rkw = dict(
        N_samples=args.N_samples,
        N_importance=args.N_importance,
        use_disp=args.use_disp,
        perturb=0.0,
        noise_std=0.0,
        white_back=dataset.white_back,
        test_time=True,
        use_fused=device.type == "cuda",
        fused_channel_io=args.fused_channel_io,
    )

    # renders are queued on the card without waiting; the window lets frame
    # i render while frame i - 1 is fetched and written.  Frames are
    # processed strictly in order.
    def submit(i):
        sample = dataset[i]
        rays = torch.from_numpy(sample["rays"]).to(device)
        return i, sample, render_image(models, rays, None, chunk=args.chunk,
                                       **rkw)

    def process(i, sample, results):
        typ = "fine" if "rgb_fine" in results else "coarse"
        img_pred = results[f"rgb_{typ}"].cpu().numpy().reshape(h, w, 3)
        if args.save_depth:
            depth_pred = np.nan_to_num(
                results[f"depth_{typ}"].cpu().numpy().reshape(h, w))
            if args.depth_format == "pfm":
                save_pfm(os.path.join(dir_name, f"depth_{i:03d}.pfm"),
                         depth_pred)
            else:
                with open(os.path.join(dir_name, f"depth_{i:03d}"), "wb") as f:
                    f.write(depth_pred.tobytes())
        img8 = (np.clip(img_pred, 0, 1) * 255).astype(np.uint8)
        imgs.append(img8)
        write_png(os.path.join(dir_name, f"{i:03d}.png"), img8)
        if "rgbs" in sample:
            gt = torch.from_numpy(sample["rgbs"].reshape(h, w, 3))
            psnrs.append(float(psnr_metric(gt, torch.from_numpy(img_pred))))

    window = EVAL_WINDOW if args.eval_window is None else args.eval_window
    inflight = deque()
    for i in range(len(dataset)):
        inflight.append(submit(i))
        if len(inflight) >= max(1, window):
            process(*inflight.popleft())
    while inflight:
        process(*inflight.popleft())

    write_gif(os.path.join(dir_name, f"{args.scene_name}.gif"), imgs, fps=30)
    if psnrs:
        mean_psnr = float(np.mean(psnrs))
        print(f"Mean PSNR : {mean_psnr:.2f}")
        return mean_psnr
    return None
