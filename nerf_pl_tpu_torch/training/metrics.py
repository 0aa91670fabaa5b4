"""Image metrics (``nerf_pl_tpu/training/metrics.py``; reference
``metrics.py``): ``mse`` and ``psnr`` with optional valid-pixel masks.
``ssim`` comes with the shadow trainers (ROADMAP.md)."""
from __future__ import annotations

from typing import Optional

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
