"""Ray generation (``nerf_pl_tpu/ops/ray_utils.py``; reference
``datasets/ray_utils.py``).

  * ``get_ray_directions(H, W, focal)``: pinhole directions
    ``((i - W/2)/f, -(j - H/2)/f, -1)`` over the integer pixel grid, with
    no +0.5 pixel-centre offset.
  * ``get_rays(directions, c2w)``: rotate into the world frame, normalise
    the direction, broadcast the camera origin.
"""
from __future__ import annotations

import torch

from .. import resolve_device


def get_ray_directions(H: int, W: int, focal: float,
                       device=None) -> torch.Tensor:
    """(H, W, 3) un-normalised camera-frame ray directions."""
    device = resolve_device(device)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -torch.ones_like(i)],
        dim=-1,
    )


def rotate(directions: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """``directions @ rot^T`` as exact f32 products and sums (no TF32):
    ``directions (..., 3)``, ``rot (..., 3, 3)`` broadcast together."""
    return (directions[..., None, :] * rot).sum(dim=-1)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """World-frame rays for one image.

    ``directions``: (H, W, 3) or (N, 3); ``c2w``: (3, 4).
    Returns ``rays_o, rays_d``, both (N, 3); ``rays_d`` is normalised."""
    rays_d = rotate(directions.reshape(-1, 3), c2w[:, :3])
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:, 3].expand(rays_d.shape)
    return rays_o, rays_d
