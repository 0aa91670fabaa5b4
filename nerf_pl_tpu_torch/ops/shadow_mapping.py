"""Differentiable shadow mapping (``nerf_pl_tpu/ops/shadow_mapping.py``;
reference ``models/efficient_shadow_mapping.py``), in plain torch.

  * ``get_normed_w``: pixel rows ``[i, j, 1, depth]`` →
    ``w = depth / (||M @ [i, j, 1]|| + 1e-5)``.
  * ``project_pixels``: ``[u, v, w_l] = w_cam * (R @ [i, j, 1]) + Q`` with
    ``R = M_L^-1 M_cam`` and ``Q = M_L^-1 (eye_cam - eye_L)``;
    ``ul = u / w_l``, ``vl = v / w_l`` behind a signed 1e-8 guard on ``w_l``.
  * ``gather_projected_depths``: clamp ``(ul, vl)`` to the viewport, truncate
    to integers and gather the light's normalised depth at ``vl * h + ul``.
  * ``generate_shadow_map``: ``diff = wl - w_light``; method 1
    ``max(diff / delta, epsilon)``, method 2 min-max normalised (per pose
    segment when ``pose_idx`` names more than one pose), 3 channels, clipped
    to [0, 1].

Every function is batched over rays: camera matrices and eyes come as
``(3,3)``/``(3,)`` or per ray ``(N,3,3)``/``(N,3)``.  Gradients follow JAX's
at ties: ``torch.maximum``/``torch.minimum`` give each side half where the
two are equal (as ``lax.max``/``lax.min``; ``torch.clamp`` would pass all of
it), a whole-batch ``min()``/``max()`` splits evenly among the tied entries,
and the per-segment min and max start from ``+inf``/``-inf`` so that only
the tied rays share the gradient (a finite start value that equals the
minimum takes a share, which ``jax.ops.segment_min`` never gives it).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

EPSILON = 1e-5


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor on ``like``'s device, filled there (a copy from the
    host would make the host wait for the card)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(hi, maximum(lo, x))``, half the gradient to
    each side at a tie."""
    return torch.minimum(_scalar(hi, x), torch.maximum(_scalar(lo, x), x))


def normalize_min_max(x, new_max=1.0, new_min=0.0, eps: float = EPSILON):
    return (x - x.min()) / (x.max() - x.min() + eps) * (new_max - new_min) + new_min


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("...kc,...c->...k")``: (3,3) or (N,3,3) times (N,3)."""
    return torch.matmul(m, v.unsqueeze(-1)).squeeze(-1)


def get_normed_w(camera_m: torch.Tensor, pixel_depth: torch.Tensor) -> torch.Tensor:
    """``(N, 4) [i, j, 1, depth]`` → ``(N, 4) [i, j, 1, w]``."""
    pix = pixel_depth[:, :3]
    norm = torch.linalg.norm(_matvec(camera_m, pix), dim=-1) + EPSILON
    normed = pixel_depth[:, 3] / norm
    return torch.cat([pix, normed[:, None]], dim=1)


def project_pixels(
    pixels: torch.Tensor,  # (N, 3) [i, j, 1]
    w_cam: torch.Tensor,  # (N,)
    R: torch.Tensor,  # (3,3) or (N,3,3)
    Q: torch.Tensor,  # (3,) or (N,3)
) -> torch.Tensor:
    """K = (ul, vl, wl): camera pixels re-projected into the light PPC.  The
    divide is guarded (signed, 1e-8) where the reference divides by a raw
    ``wl`` and gives 0/0 on a projection through the light's image plane;
    ``wl`` itself is returned unguarded."""
    coords = w_cam[:, None] * _matvec(R, pixels) + Q
    ul, vl, wl = coords[:, 0], coords[:, 1], coords[:, 2]
    eps = _scalar(1e-8, wl)
    wl_safe = torch.where(wl >= 0, torch.maximum(wl, eps), torch.minimum(wl, -eps))
    return torch.stack([ul / wl_safe, vl / wl_safe, wl], dim=1)


def _viewport_index(res: Tuple[int, int], K: torch.Tensor) -> torch.Tensor:
    """Flat light-pixel index of each projection: ``(ul, vl)`` clamped to
    the viewport and truncated; the reference indexes
    ``w_light.view(w, h)[vl, ul]``, so the row stride is ``h``."""
    w, h = res
    with torch.no_grad():
        ul = torch.clamp(K[:, 0], 0.0, w - 1.0).to(torch.int64)
        vl = torch.clamp(K[:, 1], 0.0, h - 1.0).to(torch.int64)
        return vl * h + ul


def gather_projected_depths(
    res: Tuple[int, int],
    K: torch.Tensor,  # (N, 3)
    w_light: torch.Tensor,  # (H*W,) normalised light depths
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wl`` and the light depth under each projected camera pixel."""
    return K[:, 2], w_light[_viewport_index(res, K)]


def _segment_extreme(diff: torch.Tensor, pose_idx: torch.Tensor,
                     num_poses: int, reduce: str) -> torch.Tensor:
    init = float("inf") if reduce == "amin" else float("-inf")
    start = torch.full((num_poses,), init, dtype=diff.dtype, device=diff.device)
    return start.scatter_reduce(0, pose_idx.to(torch.int64), diff, reduce,
                                include_self=True)


def generate_shadow_map(
    wl: torch.Tensor,
    w_light_bounded: torch.Tensor,
    delta: float = 1e-2,
    epsilon: float = 0.0,
    new_min: float = 0.0,
    new_max: float = 1.0,
    sigmoid: bool = False,
    mode: str = "shadow_method_1",
    pose_idx: Optional[torch.Tensor] = None,
    num_poses: int = 0,
) -> torch.Tensor:
    """(N,) depth differences → (N, 3) shadow intensities in [0, 1]."""
    diff = wl - w_light_bounded
    if mode == "shadow_method_1":
        diff = torch.maximum(diff / delta, _scalar(epsilon, diff))
    elif mode == "shadow_method_2":
        if pose_idx is not None and num_poses > 1:
            idx = pose_idx.to(torch.int64)
            lo = _segment_extreme(diff, idx, num_poses, "amin")[idx]
            hi = _segment_extreme(diff, idx, num_poses, "amax")[idx]
        else:
            lo, hi = diff.min(), diff.max()
        diff = (diff - lo) / (hi - lo + EPSILON) * (new_max - new_min) + new_min
        if sigmoid:
            diff = torch.sigmoid(diff)
    else:
        raise ValueError(f"{mode} not found")
    return _clip(torch.stack([diff, diff, diff], dim=1), 0.0, 1.0)


def _light_transform(cam_m, cam_eye, light_m, light_eye):
    """R (3,3)/(N,3,3) and Q (3,)/(N,3) from the camera into the light."""
    # inv_ex: no singularity check, which would make the host wait for the
    # card (a singular light matrix gives inf/nan, as jnp.linalg.inv)
    ml_inv = torch.linalg.inv_ex(light_m).inverse
    R = ml_inv @ cam_m
    Q = (cam_eye - light_eye) @ ml_inv.T
    return R, Q


def run_shadow_mapping(
    res: Tuple[int, int],
    cam_m: torch.Tensor,  # (3,3) or (N,3,3)
    cam_eye: torch.Tensor,  # (3,) or (N,3)
    light_m: torch.Tensor,  # (3,3)
    light_eye: torch.Tensor,  # (3,)
    pixel_depth_cam: torch.Tensor,  # (N, 4) [i, j, 1, depth]
    normed_light: torch.Tensor,  # (H*W, 4) from get_normed_w on the light
    mode: str = "shadow_method_1",
    delta: float = 1e-2,
    epsilon: float = 0.0,
    new_min: float = 0.0,
    new_max: float = 1.0,
    sigmoid: bool = False,
    pose_idx: Optional[torch.Tensor] = None,
    num_poses: int = 0,
) -> torch.Tensor:
    """The whole differentiable pipeline for a ray batch (reference
    ``run_shadow_mapping``), over per-ray poses in one pass."""
    normed_cam = get_normed_w(cam_m, pixel_depth_cam)
    R, Q = _light_transform(cam_m, cam_eye, light_m, light_eye)
    K = project_pixels(normed_cam[:, :3], normed_cam[:, 3], R, Q)
    wl, w_light_bounded = gather_projected_depths(res, K, normed_light[:, 3])
    return generate_shadow_map(
        wl, w_light_bounded, delta=delta, epsilon=epsilon, new_min=new_min,
        new_max=new_max, sigmoid=sigmoid, mode=mode,
        pose_idx=pose_idx, num_poses=num_poses,
    )


def get_projections(cam_m, cam_eye, light_m, light_eye, pixel_depth_cam):
    """Normed w then raw (ul, vl, wl) (reference ``get_projections``)."""
    normed_cam = get_normed_w(cam_m, pixel_depth_cam)
    R, Q = _light_transform(cam_m, cam_eye, light_m, light_eye)
    return project_pixels(normed_cam[:, :3], normed_cam[:, 3], R, Q)


def efficient_sm(
    cam_pixels: torch.Tensor,  # (N, 3) [i+.5, j+.5, 1]
    light_pixels: torch.Tensor,  # (H*W, 3)
    cam_results: Dict[str, torch.Tensor],  # from the sigma renderer
    light_results: Dict[str, torch.Tensor],  # whole light-view depth render
    cam_m: torch.Tensor,  # (N,3,3) or (3,3)
    cam_eye: torch.Tensor,  # (N,3) or (3,)
    light_m: torch.Tensor,  # (3,3)
    light_eye: torch.Tensor,  # (3,)
    image_shape: Tuple[int, int],
    fine_sampling: bool,
    light_has_fine: bool,
    shadow_method: str = "shadow_method_2",
    pose_idx: Optional[torch.Tensor] = None,
    num_poses: int = 0,
    out_prefix: str = "rgb",
) -> Dict[str, torch.Tensor]:
    """Ray-batch shadow compositing (reference ``efficient_sm``,
    ``models/rendering_shadows.py:359-482``): writes
    ``{out_prefix}_coarse`` (and ``_fine``) plus the reference's EPSILON
    into a copy of ``cam_results``.  The fine map is composited from the
    fine depths, as in the JAX package."""
    kwargs = dict(
        mode=shadow_method, delta=1e-2, epsilon=0.0, new_min=0.0,
        new_max=1.0, sigmoid=False, pose_idx=pose_idx, num_poses=num_poses,
    )

    def sm_from(cam_depth, light_depth):
        pd_cam = torch.cat([cam_pixels, cam_depth[:, None]], dim=1)
        pd_light = torch.cat([light_pixels, light_depth[:, None]], dim=1)
        normed_light = get_normed_w(light_m, pd_light)
        return run_shadow_mapping(
            image_shape, cam_m, cam_eye, light_m, light_eye,
            pd_cam, normed_light, **kwargs,
        )

    out = dict(cam_results)
    out[f"{out_prefix}_coarse"] = sm_from(
        cam_results["depth_coarse"], light_results["depth_coarse"]) + EPSILON
    if fine_sampling:
        light_depth = (light_results["depth_fine"] if light_has_fine
                       else light_results["depth_coarse"])
        out[f"{out_prefix}_fine"] = sm_from(
            cam_results["depth_fine"], light_depth) + EPSILON
    return out


def shadow_mapping_images(
    cam_results: Dict[str, torch.Tensor],
    light_results: Dict[str, torch.Tensor],
    cam_ms: torch.Tensor,  # (B,3,3) one per image
    cam_eyes: torch.Tensor,  # (B,3)
    light_m: torch.Tensor,
    light_eye: torch.Tensor,
    image_shape: Tuple[int, int],
    batch_size: int,
    fine_sampling: bool,
    shadow_method: str = "shadow_method_2",
) -> Dict[str, torch.Tensor]:
    """Image-space shadow compositing (reference ``shadow_mapping``,
    ``models/rendering_shadows.py:283-353``): whole H×W depth images from
    both views, one camera pose per image, +0.5 pixel centres.  The JAX
    package maps ``run_shadow_mapping`` over the images; here the images are
    one batch of rays whose camera, light depth map and min-max segment are
    those of their image."""
    w, h = image_shape
    dev = cam_ms.device
    yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    pixels = torch.stack([xx.reshape(-1) + 0.5, yy.reshape(-1) + 0.5,
                          torch.ones(h * w, device=dev)], dim=1).float()
    pixels = pixels.to(cam_ms.dtype)
    img = torch.arange(batch_size, device=dev).repeat_interleave(h * w)
    all_pix = pixels.repeat(batch_size, 1)
    R, Q = _light_transform(cam_ms, cam_eyes, light_m, light_eye)

    def composite_key(key):
        cam_d = cam_results[f"depth_{key}"].reshape(batch_size * h * w)
        light_d = light_results[f"depth_{key}"].reshape(batch_size * h * w)
        normed_cam = get_normed_w(cam_ms[img], torch.cat(
            [all_pix, cam_d[:, None]], dim=1))
        normed_light = get_normed_w(light_m, torch.cat(
            [all_pix, light_d[:, None]], dim=1))
        K = project_pixels(normed_cam[:, :3], normed_cam[:, 3], R[img], Q[img])
        # each image gathers from its own light depth map
        flat = img * (h * w) + _viewport_index(image_shape, K)
        return generate_shadow_map(
            K[:, 2], normed_light[:, 3][flat], mode=shadow_method,
            pose_idx=img, num_poses=batch_size)

    out = dict(cam_results)
    out["rgb_coarse"] = composite_key("coarse")
    if fine_sampling:
        out["rgb_fine"] = composite_key("fine")
    return out
