"""Image metrics (``nerf_pl_tpu/training/metrics.py``; reference
``metrics.py``): ``mse`` and ``psnr`` with optional valid-pixel masks, and
``ssim`` as the reference's ``1 - 2 * dssim`` with a 3x3 Gaussian window
(sigma 1.5).  No trainer calls ``ssim``, as in the JAX package."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def mse(image_pred, image_gt, valid_mask: Optional[torch.Tensor] = None,
        reduction: str = "mean"):
    value = (image_pred - image_gt) ** 2
    if valid_mask is not None:
        if reduction == "mean":
            m = valid_mask.to(value.dtype)
            # broadcast a per-pixel mask over channels if needed
            while m.dim() < value.dim():
                m = m[..., None]
            m = m.expand(value.shape)
            return (value * m).sum() / torch.clamp(m.sum(), min=1)
        return value[valid_mask]
    if reduction == "mean":
        return torch.mean(value)
    return value


def psnr(image_pred, image_gt, valid_mask=None, reduction: str = "mean"):
    return -10.0 * torch.log10(mse(image_pred, image_gt, valid_mask, reduction))


def _gaussian_kernel(size: int = 3, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (ax / sigma) ** 2)
    k = k / k.sum()
    return np.outer(k, k).astype(np.float32)


def ssim(image_pred, image_gt, window_size: int = 3, sigma: float = 1.5,
         max_val: float = 1.0):
    """SSIM over (1, C, H, W) images, the reference's
    ``1 - 2 * dssim(pred, gt, 3, 'mean')`` under its kornia 0.2.0: a
    Gaussian window at zero padding ``(window_size - 1) // 2`` (same-size
    output), and the per-pixel dissimilarity
    ``clamp(1 - ssim_map, 0, 1) / 2``, the clamp before the halving."""
    c = image_pred.shape[1]
    kern = torch.from_numpy(_gaussian_kernel(window_size, sigma)).to(
        image_pred.device, image_pred.dtype)
    kern = kern[None, None].expand(c, 1, window_size, window_size)
    pad = (window_size - 1) // 2

    def filt(x):
        return torch.nn.functional.conv2d(x, kern, padding=pad, groups=c)

    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2
    mu_p, mu_g = filt(image_pred), filt(image_gt)
    mu_pp, mu_gg, mu_pg = mu_p * mu_p, mu_g * mu_g, mu_p * mu_g
    s_pp = filt(image_pred * image_pred) - mu_pp
    s_gg = filt(image_gt * image_gt) - mu_gg
    s_pg = filt(image_pred * image_gt) - mu_pg
    num = (2 * mu_pg + C1) * (2 * s_pg + C2)
    den = (mu_pp + mu_gg + C1) * (s_pp + s_gg + C2)
    dssim = torch.clamp(1.0 - num / den, 0.0, 1.0) * 0.5
    return 1.0 - 2.0 * torch.mean(dssim)
