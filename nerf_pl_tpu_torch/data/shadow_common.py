"""Helpers shared by the shadow-map loaders (``nerf_pl_tpu/data/shadow_common.py``),
on host numpy arrays.

  * pixel rows ``[x+0.5, y+0.5, 1]`` flattened row-major;
  * the light camera: intrinsics from ``light_camera_angle_x``, pose from
    ``light_camera_transform_matrix``, rays through every light pixel;
  * targets ``sm_<frame>.png`` beside the RGB frames, read with the port's
    PNG reader, LANCZOS resize and Gaussian blur (each bit-equal to Pillow's)
    and ``convert("RGB")``.

``get_ray_directions``, ``get_rays`` and ``get_ndc_rays`` repeat the numpy
branch of ``nerf_pl_tpu/ops/ray_utils.py`` (the port's ``ops.ray_utils`` is
the torch version): pinhole directions ``((i - W/2)/f, -(j - H/2)/f, -1)``
without a +0.5 pixel-centre offset, rotated into the world frame and
normalised; the NDC warp of forward-facing scenes in the same float ops, in
the same order, so the loaders' rays keep the JAX package's bits.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..models.camera import Camera, intrinsic_matrix, pose_from_blender_matrix
from .blur import gaussian_blur
from .png import read_png
from .resize import resize_lanczos


def get_ray_directions(H: int, W: int, focal: float) -> np.ndarray:
    """(H, W, 3) un-normalised camera-frame ray directions."""
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    return np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], axis=-1)


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """World-frame ``rays_o, rays_d`` (N, 3) for one image."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def get_ndc_rays(H: int, W: int, focal: float, near, rays_o, rays_d):
    """Rays moved to the near plane ``z = -near``, then warped into NDC."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return np.stack([o0, o1, o2], axis=-1), np.stack([d0, d1, d2], axis=-1)


def make_rays(directions, c2w, near: float, far: float) -> np.ndarray:
    """(N, 8) rows ``[o, d, near, far]``, float32."""
    rays_o, rays_d = get_rays(directions, c2w)
    nf = np.ones_like(rays_o[:, :1])
    return np.concatenate(
        [rays_o, rays_d, near * nf, far * nf], axis=1
    ).astype(np.float32)


def pixel_grid(w: int, h: int) -> np.ndarray:
    """(h*w, 3) rows of [x+0.5, y+0.5, 1], row-major (y outer)."""
    yy, xx = np.meshgrid(
        np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
        indexing="ij",
    )
    return np.stack(
        [xx.reshape(-1) + 0.5, yy.reshape(-1) + 0.5, np.ones(h * w, np.float32)],
        axis=1,
    )


def posed_ppc(camera_angle_x: float, res: Tuple[int, int], c2w: np.ndarray):
    """(M, eye) for a Blender frame: hfov in degrees into the PPC intrinsics,
    then ``M <- c2w[:, :3] @ M``."""
    hfov = camera_angle_x * 180.0 / np.pi
    M = intrinsic_matrix(hfov, res)
    return pose_from_blender_matrix(M, c2w)


def _to_rgb(img: np.ndarray, mode: str) -> np.ndarray:
    """PIL's ``convert("RGB")`` for the modes the PNG reader returns."""
    if mode == "RGB":
        return img
    if mode == "RGBA":
        return img[..., :3]
    if mode in ("L", "LA"):
        gray = img if mode == "L" else img[..., 0]
        return np.repeat(gray[..., None], 3, axis=-1)
    raise ValueError(f"cannot convert PNG mode {mode!r} to RGB")


def load_sm_image(path: str, img_wh, blur: int = -1) -> np.ndarray:
    """(h*w, 3) float32 shadow-map target: the PNG resized with LANCZOS,
    blurred when ``blur != -1``, as RGB in [0, 1]."""
    img, mode = read_png(path)
    img = resize_lanczos(img, mode, img_wh)
    if blur != -1:
        img = gaussian_blur(img, blur)
    arr = _to_rgb(img, mode).astype(np.float32) / 255.0
    return arr.reshape(-1, 3)


def sm_path_for(root_dir: str, file_path: str) -> str:
    name = file_path.split("/")[-1]
    return os.path.join(root_dir, f"sm_{name}.png")


class LightRig:
    """The light 'camera' shared by every frame of a shadow dataset."""

    def __init__(
        self,
        img_wh: Tuple[int, int],
        light_camera_angle_x: float,
        l2w: np.ndarray,  # (3,4)
        near: float,
        far: float,
        base_res: int = 800,
        camera_override: Optional[np.ndarray] = None,
        eye_override: Optional[np.ndarray] = None,
    ):
        w, h = img_wh
        focal = 0.5 * base_res / np.tan(0.5 * light_camera_angle_x)
        focal *= w / base_res
        self.focal = focal
        self.l2w = np.asarray(l2w, np.float32)
        directions = get_ray_directions(h, w, focal)
        self.rays = make_rays(directions, l2w, near, far)  # (h*w, 8)
        self.pixels = pixel_grid(w, h)  # (h*w, 3)
        if camera_override is not None:
            self.camera = np.asarray(camera_override, np.float32)
            self.eye_pos = np.asarray(eye_override, np.float32)
        else:
            self.camera, self.eye_pos = posed_ppc(
                light_camera_angle_x, (w, h), l2w
            )
        self.near, self.far = near, far

    @property
    def ppc(self) -> Camera:
        return Camera.from_camera_eyepos(self.eye_pos, self.camera)

    def items(self) -> dict:
        """The light's fields of a loader's sample."""
        return {"light_ppc": {"eye_pos": self.eye_pos, "camera": self.camera},
                "light_pixels": self.pixels, "light_rays": self.rays}
