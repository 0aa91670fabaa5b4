"""Volume-rendering alpha compositing (``nerf_pl_tpu/ops/compositing.py``).

  * ``deltas = z[i+1] - z[i]`` with a 1e10 tail, scaled by ``||dir||``.
  * ``alpha = 1 - exp(-delta * relu(sigma + noise))``.
  * Transmittance: exclusive cumprod of ``[1, 1-a+1e-10, ...]``.
  * ``rgb = sum w * rgbs`` (+ ``1 - sum w`` on a white background),
    ``depth = sum w * z``, ``opacity = sum w``,
    ``disp = 1 / max(1e-10, depth / opacity)``.

Plain tensor code: the TPU ran this as XLA-fused elementwise work, with no
kernel to port.
"""
from __future__ import annotations

from typing import Optional

import torch


def compute_weights(
    sigmas: torch.Tensor,  # (N_rays, S)
    z_vals: torch.Tensor,  # (N_rays, S)
    dirs: torch.Tensor,  # (N_rays, 3), un-normalized allowed
    noise_std: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-sample compositing weights ``w_i = alpha_i * T_i``."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)], -1)
    deltas = deltas * torch.linalg.norm(dirs, dim=-1, keepdim=True)
    if noise is None:
        if noise_std > 0:
            noise = torch.randn(sigmas.shape, generator=generator,
                                dtype=sigmas.dtype, device=sigmas.device)
            noise = noise * noise_std
        else:
            noise = torch.zeros_like(sigmas)
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas + noise))
    shifted = torch.cat(
        [torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], dim=-1
    )
    transmittance = torch.cumprod(shifted, dim=-1)[:, :-1]
    return alphas * transmittance


def composite(
    weights: torch.Tensor,  # (N_rays, S)
    z_vals: torch.Tensor,  # (N_rays, S)
    rgbs: Optional[torch.Tensor] = None,  # (N_rays, S, 3)
    white_back: bool = False,
) -> dict:
    """Reduce weights into ``depth``, ``opacity``, ``disp`` and, when
    ``rgbs`` is given, ``rgb``."""
    opacity = weights.sum(dim=1)
    depth = torch.sum(weights * z_vals, dim=-1)
    disp = 1.0 / torch.clamp(depth / opacity, min=1e-10)
    out = {"depth": depth, "opacity": opacity, "disp": disp}
    if rgbs is not None:
        rgb = torch.sum(weights[..., None] * rgbs, dim=-2)
        if white_back:
            rgb = rgb + (1.0 - opacity[..., None])
        out["rgb"] = rgb
    return out
