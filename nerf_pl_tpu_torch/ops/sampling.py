"""Depth sampling along rays (``nerf_pl_tpu/ops/sampling.py``).

  * ``stratified_z_vals`` — linear in depth or disparity over [near, far].
  * ``perturb_z_vals`` — jitter inside midpoint-bounded intervals.
  * ``sample_pdf`` — the fork's inverse-CDF sampler: zero-padded CDF of
    ``weights + eps``; random mode takes ``searchsorted(cdf, u) - 1``
    clamped to ``[0, N-1]`` plus a uniform jitter; det mode takes a
    linspace ``u`` and, in place of the jitter, the exact position of each
    ``u`` within its CDF bin (``searchsorted_interp``, no gathers).

Random draws come from a ``torch.Generator`` or are injected (``u``,
``jitter``, ``rand``) so tests can feed both packages the same numbers.
The [0, 1] steps are ``i * (1 / (n - 1))`` and an exact 1 last, the bits of
``jnp.linspace`` as XLA:CPU computes it (``torch.linspace`` rounds some steps
the other way, and at the shadow scenes' far plane of 200 one ulp of depth
moves the 2^9-frequency encoding by ~5e-3 rad).
"""
from __future__ import annotations

from typing import Optional

import torch

from .searchsorted import searchsorted, searchsorted_interp


def unit_steps(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``n`` steps from 0 to 1 with ``jnp.linspace(0, 1, n)``'s bits."""
    if n < 2:
        return torch.zeros(n, dtype=dtype, device=device)
    # the Python scalar is rounded to ``dtype`` before the product; the
    # tensors are made on ``device`` (a copy from the host would wait)
    steps = torch.arange(n - 1, dtype=dtype, device=device) * (1.0 / (n - 1))
    return torch.cat([steps, torch.ones(1, dtype=dtype, device=device)])


def stratified_z_vals(near: torch.Tensor, far: torch.Tensor, N_samples: int,
                      use_disp: bool = False) -> torch.Tensor:
    """(N_rays, N_samples) linearly spaced depths (or disparities)."""
    z_steps = unit_steps(N_samples, near.dtype, near.device)
    if not use_disp:
        return near * (1.0 - z_steps) + far * z_steps
    return 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)


def perturb_z_vals(z_vals: torch.Tensor, perturb: float,
                   generator: Optional[torch.Generator] = None,
                   rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Jitter each sample uniformly within its midpoint-bounded interval."""
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    upper = torch.cat([z_mid, z_vals[:, -1:]], dim=-1)
    lower = torch.cat([z_vals[:, :1], z_mid], dim=-1)
    if rand is None:
        rand = torch.rand(z_vals.shape, generator=generator,
                          dtype=z_vals.dtype, device=z_vals.device)
    return lower + (upper - lower) * perturb * rand


def sample_pdf(
    rays: torch.Tensor,  # (N_rays, 8): [..., -2:] = near, far
    weights: torch.Tensor,  # (N_rays, N_samples_)
    N_importance: int,
    det: bool = False,
    eps: float = 1e-5,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
    jitter: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns (N_rays, N_importance) depths."""
    N_rays, N_samples_ = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)

    needs_rng = not det and (u is None or jitter is None)
    if needs_rng and generator is None:
        raise ValueError("sample_pdf needs a generator when u/jitter not given")
    like = dict(dtype=weights.dtype, device=weights.device)
    if u is None:
        if det:
            u = unit_steps(N_importance, **like)
            u = u.expand(N_rays, N_importance)
        else:
            u = torch.rand((N_rays, N_importance), generator=generator, **like)
    near, far = rays[:, -2:-1], rays[:, -1:]

    if det and jitter is None:
        ranks, lo, hi = searchsorted_interp(cdf, u)
        inds = torch.clamp(ranks - 1, 0, N_samples_ - 1).to(weights.dtype)
        offset = torch.clamp((u - lo) / torch.clamp(hi - lo, min=eps), 0.0, 1.0)
        z_steps = (inds + offset) / N_samples_
        return near * (1.0 - z_steps) + far * z_steps

    # clamp both ends: u = 1.0 lands past the last CDF entry
    inds = torch.clamp(searchsorted(cdf, u, side="right") - 1, 0,
                       N_samples_ - 1).to(weights.dtype)
    if jitter is not None:
        offset = jitter
    else:
        offset = torch.rand((N_rays, N_importance), generator=generator, **like)
    z_steps = (inds + offset) / N_samples_
    return near * (1.0 - z_steps) + far * z_steps


def sample_pdf_bins(
    bins: torch.Tensor,  # (N_rays, N_samples_ + 1) bin edges (z midpoints)
    weights: torch.Tensor,  # (N_rays, N_samples_)
    N_importance: int,
    det: bool = False,
    eps: float = 1e-5,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(N_rays, N_importance) depths by the inverse CDF over ``bins``."""
    N_rays, N_samples_ = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    if u is None:
        like = dict(dtype=weights.dtype, device=weights.device)
        if det:
            u = unit_steps(N_importance, **like).expand(N_rays, N_importance)
        else:
            if generator is None:
                raise ValueError("sample_pdf_bins needs a generator when u "
                                 "is not given")
            u = torch.rand((N_rays, N_importance), generator=generator, **like)
    inds = searchsorted(cdf, u, side="right").long()
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=N_samples_)
    cdf_g0 = torch.gather(cdf, 1, below)
    cdf_g1 = torch.gather(cdf, 1, above)
    bins_g0 = torch.gather(bins, 1, below)
    bins_g1 = torch.gather(bins, 1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_g0 + (u - cdf_g0) / denom * (bins_g1 - bins_g0)
