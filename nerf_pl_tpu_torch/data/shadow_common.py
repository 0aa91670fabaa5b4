"""Ray helpers shared by the dataset loaders
(``nerf_pl_tpu/data/shadow_common.py``), on host numpy arrays.

``get_ray_directions`` and ``get_rays`` repeat the numpy branch of
``nerf_pl_tpu/ops/ray_utils.py`` (the port's ``ops.ray_utils`` is the torch
version for the renderer): pinhole directions ``((i - W/2)/f,
-(j - H/2)/f, -1)`` without a +0.5 pixel-centre offset, rotated into the
world frame and normalised.
"""
from __future__ import annotations

import numpy as np


def get_ray_directions(H: int, W: int, focal: float) -> np.ndarray:
    """(H, W, 3) un-normalised camera-frame ray directions."""
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    return np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], axis=-1)


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """World-frame ``rays_o, rays_d`` (N, 3) for one image."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def make_rays(directions, c2w, near: float, far: float) -> np.ndarray:
    """(N, 8) rows ``[o, d, near, far]``, float32."""
    rays_o, rays_d = get_rays(directions, c2w)
    nf = np.ones_like(rays_o[:, :1])
    return np.concatenate(
        [rays_o, rays_d, near * nf, far * nf], axis=1
    ).astype(np.float32)
