"""Orbit-render a trained model along a spherical camera path (the
counterpart of ``examples/orbit_render.py``, the script form of the
reference's ``test.ipynb``): one PNG a pose, rgb or, with ``--mode sigma``,
the JET-coloured fine depth, and a GIF of the orbit at 12 fps.

    python -m nerf_pl_tpu_torch.examples.orbit_render \
        --ckpt_path ckpts/exp/epoch=N.ckpt --img_wh 64 64 --radius 4.0 \
        --n_poses 24 --out_dir /tmp/orbit [--mode sigma] [--device cuda|cpu]

Every flag of the JAX script parses as it does there, and the same lines
are printed.  Rendering is ``render_image`` at perturb 0 and noise 0, in
float32, in chunks of 32,768 rays; on the card it takes the fused MLP
(kernel C, channel-major, a coarse and a fine pass a chunk) and kernel B
(the importance sampler's bisection, once a chunk), as the JAX script takes
the Pallas kernels on a TPU; on the CPU it takes posenc + NeRF, as JAX does
off the TPU.  Frames are quantised by truncation, ``(img * 255)`` cast to
uint8, as the JAX script does, and written with the port's PNG and GIF
writers (``data/png.py``, ``utils/gif.py``).  ``--device`` (default
``cuda``) is the port's own; the script refuses to run without a card
unless given ``cpu``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import resolve_device
from ..data.png import write_png
from ..models.camera import c2w_from_lookat
from ..ops.ray_utils import get_ray_directions, get_rays
from ..tools.evaluate import load_models
from ..tools.render import render_image
from ..utils.gif import write_gif
from ..utils.visualization import visualize_depth

GIF_FPS = 12


def get_opts(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_path", required=True)
    ap.add_argument("--img_wh", nargs="+", type=int, default=[64, 64])
    ap.add_argument("--radius", type=float, default=4.0)
    ap.add_argument("--height", type=float, default=0.5)
    ap.add_argument("--n_poses", type=int, default=24)
    ap.add_argument("--N_samples", type=int, default=64)
    ap.add_argument("--N_importance", type=int, default=64)
    ap.add_argument("--near", type=float, default=2.0)
    ap.add_argument("--far", type=float, default=6.0)
    ap.add_argument("--camera_angle_x", type=float, default=0.6911)
    ap.add_argument("--mode", default="rgb", choices=["rgb", "sigma"])
    ap.add_argument("--out_dir", default="orbit_out")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def orbit_rays(args, i: int, directions: torch.Tensor) -> torch.Tensor:
    """(h * w, 8) rays of pose ``i`` of the orbit, on ``directions``'
    device: the camera at angle 2 pi i / n_poses, looking at the origin."""
    theta = 2 * np.pi * i / args.n_poses
    eye = np.array([args.radius * np.sin(theta), args.height,
                    args.radius * np.cos(theta)], np.float32)
    c2w = c2w_from_lookat(eye, np.zeros(3, np.float32))[:3, :4]
    c2w = torch.from_numpy(np.ascontiguousarray(c2w, np.float32))
    rays_o, rays_d = get_rays(directions, c2w.to(directions.device))
    nf = torch.ones_like(rays_o[:, :1])
    return torch.cat([rays_o, rays_d, args.near * nf, args.far * nf], 1)


def render_pose(models, rays: torch.Tensor, args, use_fused: bool) -> dict:
    """``render_image`` of one pose as the JAX script calls it."""
    return render_image(models, rays, None, N_samples=args.N_samples,
                        N_importance=args.N_importance, perturb=0.0,
                        noise_std=0.0, white_back=True, mode=args.mode,
                        use_fused=use_fused)


def frame_of(out: dict, args) -> np.ndarray:
    """The (h, w, 3) uint8 frame of one render, truncated as JAX does."""
    w, h = args.img_wh
    if args.mode == "rgb":
        img = np.clip(out["rgb_fine"].cpu().numpy().reshape(h, w, 3), 0, 1)
    else:
        img = visualize_depth(
            out["depth_fine"].cpu().numpy().reshape(h, w)).transpose(1, 2, 0)
    return (img * 255).astype(np.uint8)


def main(argv=None) -> list:
    """Render the orbit and write its files; returns the uint8 frames."""
    args = get_opts(argv)
    device = resolve_device(args.device)
    w, h = args.img_wh
    focal = 0.5 * 800 / np.tan(0.5 * args.camera_angle_x) * w / 800
    directions = get_ray_directions(h, w, focal, device=device)
    models = load_models(args.ckpt_path, device)
    os.makedirs(args.out_dir, exist_ok=True)

    frames = []
    for i in range(args.n_poses):
        out = render_pose(models, orbit_rays(args, i, directions), args,
                          use_fused=device.type == "cuda")
        img8 = frame_of(out, args)
        write_png(os.path.join(args.out_dir, f"orbit_{i:03d}.png"), img8)
        frames.append(img8)
        print(f"pose {i + 1}/{args.n_poses}", flush=True)
    write_gif(os.path.join(args.out_dir, "orbit.gif"), frames, fps=GIF_FPS)
    print(f"wrote {args.out_dir}/orbit.gif")
    return frames


if __name__ == "__main__":
    main()
