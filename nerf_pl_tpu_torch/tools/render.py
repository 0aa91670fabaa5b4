"""Whole-image rendering in chunks of rays (``nerf_pl_tpu/tools/render.py``;
reference ``train.py:53-63``, ``eval.py:65-67``).

The JAX package pads the rays to a multiple of a static chunk and maps the
renderer over the chunks inside one compiled program; PyTorch runs eagerly,
so on one device the chunks are a loop and the last one is simply shorter.
Over a mesh of d ranks the rays are padded as JAX pads them
(``plan_chunks``), each rank renders its contiguous run of ``n_chunks / d``
chunks, and the outputs are gathered so every rank holds the whole image.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.rendering import render_rays
from ..parallel.mesh import Mesh, all_gather_rows


def plan_chunks(n: int, chunk: int, d: int):
    """Chunk/padding plan for n rays over d devices -> (chunk, n_chunks,
    n_pad), where n_chunks divides d and n_chunks*chunk >= n.

    Never renders (much) more padding than rays: the chunk is capped at one
    device's share of the image.
    """
    chunk = min(chunk, max(8, -(-n // d)))
    n_chunks = -(-n // chunk)
    n_chunks = -(-n_chunks // d) * d
    return chunk, n_chunks, n_chunks * chunk - n


def _render_chunks(models, rays, generator, chunk, render_kwargs):
    parts = []
    with torch.no_grad():
        for rays_c in rays.split(chunk):
            parts.append(render_rays(models.get("coarse"), models.get("fine"),
                                     rays_c, generator, **render_kwargs))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def render_image(
    models: Dict[str, torch.nn.Module],
    rays: torch.Tensor,  # (N, 8)
    generator: Optional[torch.Generator],
    chunk: int = 32 * 1024,
    mesh: Optional[Mesh] = None,
    **render_kwargs,
) -> Dict[str, torch.Tensor]:
    """Render N rays with bounded memory under ``torch.no_grad()``; returns
    the ``render_rays`` dict with every output concatenated over the rays.
    With ``use_fused``, ``fused_channel_io`` defaults to True (the
    channel-major kernel C), as in JAX, unless the caller sets it.  Every
    rank of ``mesh`` must call it with the same rays."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if render_kwargs.get("use_fused"):
        render_kwargs.setdefault("fused_channel_io", True)
    if mesh is None or mesh.size == 1:
        return _render_chunks(models, rays, generator, chunk, render_kwargs)
    n, d = rays.shape[0], mesh.size
    chunk, n_chunks, n_pad = plan_chunks(n, chunk, d)
    if n_pad:
        rays = torch.cat([rays, rays[-1:].expand(n_pad, rays.shape[-1])])
    per = n_chunks // d * chunk  # this rank's rows
    mine = rays[mesh.rank * per:(mesh.rank + 1) * per]
    out = _render_chunks(models, mine, generator, chunk, render_kwargs)
    return {k: all_gather_rows(v, mesh)[:n] for k, v in out.items()}
