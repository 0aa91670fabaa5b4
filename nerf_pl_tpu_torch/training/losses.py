"""Training losses (``nerf_pl_tpu/training/losses.py``; reference
``losses.py``).

  * ``mse_loss``     — mean-squared error on ``rgb_coarse`` plus ``rgb_fine``
    when present.
  * ``sm_loss``      — the same on the ``sm_coarse`` / ``sm_fine`` keys.
  * ``opacity_loss`` — threshold the target at ``sm_thres`` into shadow and
    non-shadow pixel sets and penalise
    ``coeff - |mean(non_sm_opacity) - mean(sm_opacity)|`` on the coarse
    (+ fine) opacities, as masked means; 0 unless both sets are non-empty.
"""
from __future__ import annotations

import torch


def mse_loss(results, targets):
    loss = torch.mean((results["rgb_coarse"] - targets) ** 2)
    if "rgb_fine" in results:
        loss = loss + torch.mean((results["rgb_fine"] - targets) ** 2)
    return loss


def sm_loss(results, targets):
    loss = torch.mean((results["sm_coarse"] - targets) ** 2)
    if "sm_fine" in results:
        loss = loss + torch.mean((results["sm_fine"] - targets) ** 2)
    return loss


def _masked_mean(x, mask):
    cnt = mask.sum()
    return torch.where(cnt > 0, (x * mask).sum() / torch.clamp(cnt, min=1),
                       torch.zeros_like(cnt))


def opacity_loss(results, targets, coeff: float = 2000.0,
                 sm_thres: float = 0.4):
    gray = targets.sum(dim=-1) / 3.0
    sm_mask = (gray > sm_thres).to(targets.dtype)
    non_sm_mask = 1.0 - sm_mask
    any_both = (sm_mask.sum() > 0) & (non_sm_mask.sum() > 0)

    def term(opacity):
        sm_mean = _masked_mean(opacity, sm_mask)
        non_mean = _masked_mean(opacity, non_sm_mask)
        return coeff - torch.abs(non_mean - sm_mean)

    loss = term(results["opacity_coarse"])
    if "opacity_fine" in results:
        loss = loss + term(results["opacity_fine"])
    return torch.where(any_both, loss, torch.zeros_like(loss))


loss_dict = {"mse": mse_loss, "sm": sm_loss, "opacity": opacity_loss}
