"""Entry point of the port (the counterpart of ``__graft_entry__.entry``).

``entry()`` returns ``(fn, args)``: a forward render step of the flagship
model (coarse + fine reference NeRF, 64 + 128 samples, perturb and noise
on) over 256 rays; ``fn(*args)`` is ``rgb_fine``, (256, 3).
"""
from __future__ import annotations

import torch

from . import resolve_device
from .models.nerf import init_nerf
from .ops.rendering import render_rays


def flagship_models(seed: int = 0, device=None) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {name: init_nerf(gen, device=device) for name in ("coarse", "fine")}


def make_rays(gen: torch.Generator, n: int, near: float = 2.0,
              far: float = 6.0, device=None) -> torch.Tensor:
    """(n, 8) rays near the origin with random unit directions."""
    o = torch.randn((n, 3), generator=gen) * 0.1
    d = torch.randn((n, 3), generator=gen)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    nf = torch.ones((n, 1))
    return torch.cat([o, d, near * nf, far * nf], -1).to(resolve_device(device))


def entry(device=None):
    """Returns ``(fn, example_args)``: a forward render step."""
    device = resolve_device(device)
    models = flagship_models(0, device)
    rays = make_rays(torch.Generator().manual_seed(2), 256, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def fn(models, rays, generator):
        with torch.no_grad():
            out = render_rays(
                models["coarse"], models["fine"], rays, generator,
                N_samples=64, N_importance=128, perturb=1.0, noise_std=1.0,
                white_back=True, use_fused=True, fused_channel_io=True)
        return out["rgb_fine"]

    return fn, (models, rays, gen)
