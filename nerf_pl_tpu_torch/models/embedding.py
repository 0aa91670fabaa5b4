"""Positional (Fourier-feature) encoding.

Channel order (``nerf_pl_tpu/models/embedding.py``): the identity first,
then for each frequency ``2^k`` a ``C``-channel sin block followed by a
``C``-channel cos block.  Output channels = ``C * (2 * n_freqs + 1)``.
"""
from __future__ import annotations

import torch


def freq_bands(n_freqs: int, logscale: bool = True) -> list:
    if logscale:
        return [2.0 ** k for k in range(n_freqs)]
    if n_freqs == 1:
        return [1.0]
    top = 2.0 ** (n_freqs - 1)
    return [1.0 + (top - 1.0) * k / (n_freqs - 1) for k in range(n_freqs)]


def posenc(x: torch.Tensor, n_freqs: int, logscale: bool = True) -> torch.Tensor:
    """Encode ``x (..., C)`` to ``(..., C * (2 * n_freqs + 1))``."""
    if n_freqs == 0:
        return x
    bands = torch.tensor(freq_bands(n_freqs, logscale), dtype=x.dtype,
                         device=x.device)
    xb = x[..., None, :] * bands[:, None]  # (..., F, C)
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # (..., F, 2, C)
    sc = sc.reshape(*x.shape[:-1], 2 * n_freqs * x.shape[-1])
    return torch.cat([x, sc], dim=-1)
