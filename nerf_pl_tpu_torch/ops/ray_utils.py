"""Ray generation (``nerf_pl_tpu/ops/ray_utils.py``; reference
``datasets/ray_utils.py``).

  * ``get_ray_directions(H, W, focal)``: pinhole directions
    ``((i - W/2)/f, -(j - H/2)/f, -1)`` over the integer pixel grid, with
    no +0.5 pixel-centre offset.
  * ``get_rays(directions, c2w)``: rotate into the world frame, normalise
    the direction, broadcast the camera origin.
  * ``get_ndc_rays``: move each origin to the near plane ``z = -near``, then
    the projective NDC warp of forward-facing scenes (the loaders use the
    numpy copy in ``data/shadow_common.py``, which keeps the JAX package's
    bits).
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


def get_ndc_rays(H: int, W: int, focal: float, near, rays_o: torch.Tensor,
                 rays_d: torch.Tensor):
    """World-frame rays (..., 3) warped into NDC."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)
