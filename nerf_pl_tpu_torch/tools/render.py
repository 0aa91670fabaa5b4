"""Whole-image rendering in chunks of rays (``nerf_pl_tpu/tools/render.py``;
reference ``train.py:53-63``, ``eval.py:65-67``).

The JAX package pads the rays to a multiple of a static chunk and maps the
renderer over the chunks inside one compiled program; PyTorch runs eagerly,
so here the chunks are a loop and the last one is simply shorter.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.rendering import render_rays


def render_image(
    models: Dict[str, torch.nn.Module],
    rays: torch.Tensor,  # (N, 8)
    generator: Optional[torch.Generator],
    chunk: int = 32 * 1024,
    **render_kwargs,
) -> Dict[str, torch.Tensor]:
    """Render N rays with bounded memory under ``torch.no_grad()``; returns
    the ``render_rays`` dict with every output concatenated over the rays.
    With ``use_fused``, ``fused_channel_io`` defaults to True (the
    channel-major kernel C), as in JAX, unless the caller sets it."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if render_kwargs.get("use_fused"):
        render_kwargs.setdefault("fused_channel_io", True)
    parts = []
    with torch.no_grad():
        for rays_c in rays.split(chunk):
            parts.append(render_rays(models.get("coarse"), models.get("fine"),
                                     rays_c, generator, **render_kwargs))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
