"""The coarse -> fine volume renderer (``nerf_pl_tpu/ops/rendering.py``).

Modes:
  * ``rgb``      — keys ``rgb_/depth_/opacity_{coarse,fine}``; ``test_time``
    with a fine pass runs the coarse model sigma-only and returns only
    ``opacity_coarse`` for it.
  * ``sigma``    — sigma-only queries; keys
    ``depth_/opacity_/disp_map_{coarse,fine}``.
  * ``rgb_disp`` — the rgb keys plus ``disp_map_*``.

Every random draw comes from ``generator`` or from ``overrides`` with the
JAX keys ``perturb_rand``, ``noise_coarse``, ``u``, ``jitter`` and
``noise_fine``, so tests can feed both packages the same numbers.
``generator=None`` is allowed only when every draw is deterministic or
injected.  The fine z-samples are detached where the reference detaches.
``remat_fine`` recomputes the fine pass in the backward
(``torch.utils.checkpoint``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..models.embedding import posenc
from .compositing import composite, compute_weights
from .fused_mlp import (RAW_COLS, fused_nerf_apply, fused_nerf_apply_raw,
                        fused_nerf_apply_raw_t, supports_fused,
                        supports_fused_wide)
from .sampling import perturb_z_vals, sample_pdf, stratified_z_vals

Results = Dict[str, torch.Tensor]


def _query(model, xyz: torch.Tensor, dirs: Optional[torch.Tensor],
           xyz_freqs: int, sigma_only: bool, compute_dtype,
           use_fused: bool = False, dir_freqs: int = 4,
           fused_channel_io: bool = False, fused_wide_infer: bool = False):
    """Run the MLP on ``xyz (N_rays, S, 3)`` with raw ``dirs (N_rays, 3)``
    (None when sigma-only).  Returns ``sigmas (N, S)`` and ``rgbs (N, S, 3)``
    or None.

    ``use_fused`` at the reference architecture and embedding takes the
    fused MLP: channel-major through ``fused_nerf_apply_raw_t`` (kernels
    C-F on a CUDA tensor) with ``fused_channel_io``, else row-major through
    ``fused_nerf_apply_raw`` (kernels C'-F').  With ``fused_wide_infer``, a
    wide trunk that ``supports_fused_wide`` admits at the compute dtype
    (rendering.py:78-101) is embedded here and takes ``fused_nerf_apply``
    (kernel G); the reference width ignores the flag.  Anything else (other
    widths included, as in JAX) takes ``posenc`` + ``NeRF``."""
    N_rays, S, _ = xyz.shape
    P = N_rays * S
    fused = (use_fused and supports_fused(model) and xyz_freqs == 10
             and (sigma_only or dir_freqs == 4))
    wide = (use_fused and fused_wide_infer and not fused and xyz_freqs == 10
            and (sigma_only or dir_freqs == 4)
            and supports_fused_wide(model, compute_dtype))
    if fused and not fused_channel_io:
        xyz_flat = xyz.reshape(P, 3)
        if sigma_only:
            out = fused_nerf_apply_raw(model, xyz_flat, None, compute_dtype)
            return out.reshape(N_rays, S), None
        dirs_pt = dirs[:, None, :].expand(N_rays, S, 3).reshape(P, 3)
        out = fused_nerf_apply_raw(model, xyz_flat, dirs_pt, compute_dtype)
        out = out.reshape(N_rays, S, 4)
        return out[..., 3], out[..., :3]
    if fused:
        xyz_t = xyz.permute(2, 0, 1).reshape(3, P)
        if sigma_only:
            rest = xyz_t.new_zeros((RAW_COLS - 3, P))
        else:
            dirs_t = dirs.T[:, :, None].expand(3, N_rays, S).reshape(3, P)
            rest = torch.cat([dirs_t, xyz_t.new_zeros((RAW_COLS - 6, P))])
        x_t = torch.cat([xyz_t, rest]).contiguous()
        outT = fused_nerf_apply_raw_t(model, x_t, sigma_only, compute_dtype)
        if sigma_only:
            return outT[0].reshape(N_rays, S), None
        sigmas = outT[3].reshape(N_rays, S)
        rgbs = outT[:3].reshape(3, N_rays, S).permute(1, 2, 0)
        return sigmas, rgbs
    x = posenc(xyz.reshape(P, 3), xyz_freqs)
    if not sigma_only:
        # embed per ray THEN broadcast (S x fewer transcendentals)
        dir_emb = posenc(dirs, dir_freqs)
        dir_emb = dir_emb[:, None, :].expand(N_rays, S, dir_emb.shape[-1])
        x = torch.cat([x, dir_emb.reshape(P, -1)], dim=-1)
    if wide:
        out = fused_nerf_apply(model, x, sigma_only, compute_dtype)
    else:
        out = model(x, sigma_only=sigma_only, compute_dtype=compute_dtype)
    if sigma_only:
        return out.reshape(N_rays, S), None
    out = out.reshape(N_rays, S, 4)
    return out[..., 3], out[..., :3]


def render_rays(
    model_coarse,
    model_fine,
    rays: torch.Tensor,  # (N_rays, 8) = [o, d, near, far]
    generator: Optional[torch.Generator],
    *,
    N_samples: int = 64,
    use_disp: bool = False,
    perturb: float = 0.0,
    noise_std: float = 1.0,
    N_importance: int = 0,
    white_back: bool = False,
    test_time: bool = False,
    mode: str = "rgb",
    xyz_freqs: int = 10,
    dir_freqs: int = 4,
    compute_dtype=torch.float32,
    use_fused: bool = False,
    fused_channel_io: bool = False,
    fused_wide_infer: bool = False,
    remat_fine: bool = False,
    overrides: Optional[Dict[str, torch.Tensor]] = None,
) -> Results:
    """Render a batch of rays coarse(+fine).  See the module docstring."""
    if mode not in ("rgb", "sigma", "rgb_disp"):
        raise ValueError(f"unknown mode {mode!r}")
    ov = overrides or {}
    sigma_mode = mode == "sigma"
    want_disp = mode in ("sigma", "rgb_disp")

    N_rays = rays.shape[0]
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]

    if generator is None:
        needs_rng = (
            (perturb > 0 and "perturb_rand" not in ov)
            or (noise_std > 0 and "noise_coarse" not in ov)
            # sample_pdf draws both u and jitter unless det (perturb == 0)
            or (N_importance > 0 and perturb > 0
                and ("u" not in ov or "jitter" not in ov))
            or (N_importance > 0 and noise_std > 0 and "noise_fine" not in ov)
        )
        if needs_rng:
            raise ValueError(
                "render_rays(generator=None) requires either deterministic "
                "settings (perturb=0, noise_std=0) or injected overrides "
                "for every random draw")

    dirs_for_query = None if sigma_mode else rays_d
    z_vals = stratified_z_vals(near, far, N_samples, use_disp)
    z_vals = z_vals.expand(N_rays, N_samples)
    if perturb > 0:
        z_vals = perturb_z_vals(z_vals, perturb, generator=generator,
                                rand=ov.get("perturb_rand"))
    xyz_coarse = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]

    result: Results = {}
    # test_time skips the coarse rgb head only when a fine pass will make
    # the image (reference rendering.py:237-241)
    coarse_sigma_only = sigma_mode or (test_time and N_importance > 0)
    qkw = dict(use_fused=use_fused, dir_freqs=dir_freqs,
               fused_channel_io=fused_channel_io,
               fused_wide_infer=fused_wide_infer)
    sigmas_c, rgbs_c = _query(model_coarse, xyz_coarse, dirs_for_query,
                              xyz_freqs, coarse_sigma_only, compute_dtype,
                              **qkw)
    weights_coarse = compute_weights(sigmas_c, z_vals, rays_d, noise_std,
                                     generator=generator,
                                     noise=ov.get("noise_coarse"))
    if coarse_sigma_only and not sigma_mode:
        result["opacity_coarse"] = weights_coarse.sum(dim=1)
    else:
        comp = composite(weights_coarse, z_vals, rgbs_c,
                         white_back=white_back and not sigma_mode)
        result["depth_coarse"] = comp["depth"]
        result["opacity_coarse"] = comp["opacity"]
        if not sigma_mode:
            result["rgb_coarse"] = comp["rgb"]
        if want_disp:
            result["disp_map_coarse"] = comp["disp"]

    if N_importance > 0:
        z_fine = sample_pdf(rays, weights_coarse[:, 1:-1], N_importance,
                            det=(perturb == 0), generator=generator,
                            u=ov.get("u"), jitter=ov.get("jitter"))
        z_fine = z_fine.detach()
        z_all = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values
        xyz_fine = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]
        def fine_query(model, xyz, dirs):
            return _query(model, xyz, dirs, xyz_freqs, sigma_mode,
                          compute_dtype, **qkw)

        if remat_fine and torch.is_grad_enabled():
            # recompute the fine MLP in the backward instead of keeping its
            # activations (rendering.py:268-271 wraps it in jax.checkpoint)
            sigmas_f, rgbs_f = checkpoint(fine_query, model_fine, xyz_fine,
                                          dirs_for_query, use_reentrant=False)
        else:
            sigmas_f, rgbs_f = fine_query(model_fine, xyz_fine, dirs_for_query)
        weights_fine = compute_weights(sigmas_f, z_all, rays_d, noise_std,
                                       generator=generator,
                                       noise=ov.get("noise_fine"))
        comp = composite(weights_fine, z_all, rgbs_f,
                         white_back=white_back and not sigma_mode)
        result["depth_fine"] = comp["depth"]
        result["opacity_fine"] = comp["opacity"]
        if not sigma_mode:
            result["rgb_fine"] = comp["rgb"]
        if want_disp:
            result["disp_map_fine"] = comp["disp"]
    return result
