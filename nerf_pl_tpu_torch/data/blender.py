"""Blender synthetic dataset, NeRF ``transforms_*.json`` format
(``nerf_pl_tpu/data/blender.py``; reference ``datasets/blender.py``).

  * focal = ``0.5 * 800 / tan(0.5 * camera_angle_x)`` scaled by ``w / 800``.
  * train split: one flattened buffer of all rays ``(n_imgs * h * w, 8)``,
    ``[o, d, near, far]``, and the RGBA-over-white blended colours.
  * val split: per-image samples with a ``valid_mask`` from the alpha.
  * ``black_and_white``: PIL's fixed-point luma replicated over the three
    channels, with no alpha blend (as the reference).
  * near/far and ``white_back`` are arguments (upstream 2/6 by default).

Images are opened by their content (PNG or JPEG, in Pillow's mode) and
resized to ``img_wh`` with PIL's LANCZOS in that mode, then converted, all
as Pillow does (``data/image.py``).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .image import convert, read_picture, resize
from .sharding import wrap_pad_shard
from .shadow_common import get_ray_directions, make_rays


def _load_image(path, img_wh, black_and_white=False):
    """Returns (h*w, 4) float32 RGBA in [0, 1] (grayscale replicated if bw)."""
    pic = resize(read_picture(path), img_wh)
    if black_and_white:
        alpha = None
        if pic.mode == "RGBA":
            alpha = pic.pixels[..., 3].astype(np.float32) / 255.0
        g = convert(pic, "L").astype(np.float32) / 255.0
        rgb = np.stack([g, g, g], axis=-1)
        a = alpha if alpha is not None else np.ones_like(g)
        return np.concatenate([rgb, a[..., None]], -1).reshape(-1, 4)
    return (convert(pic, "RGBA").astype(np.float32) / 255.0).reshape(-1, 4)


def blend_rgba(img: np.ndarray) -> np.ndarray:
    """``rgb * a + (1 - a)``: alpha over white, with or without white_back,
    as the reference does (datasets/blender.py:77-80)."""
    rgb, a = img[:, :3], img[:, 3:4]
    return rgb * a + (1.0 - a)


class BlenderDataset:
    white_back_default = True

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        img_wh=(800, 800),
        near: float = 2.0,
        far: float = 6.0,
        white_back: Optional[bool] = None,
        black_and_white: bool = False,
        val_num: int = 8,
        frame_shard=None,
    ):
        if img_wh[0] != img_wh[1]:
            raise ValueError("image width must equal image height!")
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.near, self.far = float(near), float(far)
        self.white_back = (
            self.white_back_default if white_back is None else bool(white_back)
        )
        self.black_and_white = black_and_white
        self.val_num = val_num
        # (offset, step): this host reads frames[offset::step], wrap-padded
        self.frame_shard = frame_shard
        self._read_meta()

    def _read_meta(self):
        with open(os.path.join(self.root_dir,
                               f"transforms_{self.split}.json")) as f:
            self.meta = json.load(f)
        w, h = self.img_wh
        self.focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        self.focal *= w / 800.0
        self.bounds = np.array([self.near, self.far], dtype=np.float32)
        self.directions = get_ray_directions(h, w, self.focal)  # (h, w, 3)

        if self.split == "train":
            frames = self.meta["frames"]
            if self.frame_shard is not None:
                frames = wrap_pad_shard(frames, self.frame_shard)
            rays, rgbs, poses, paths = [], [], [], []
            for frame in frames:
                pose = np.array(frame["transform_matrix"],
                                dtype=np.float32)[:3, :4]
                poses.append(pose)
                path = os.path.join(self.root_dir, f"{frame['file_path']}.png")
                paths.append(path)
                img = _load_image(path, self.img_wh, self.black_and_white)
                rgbs.append(img[:, :3] if self.black_and_white
                            else blend_rgba(img))
                rays.append(make_rays(self.directions, pose, self.near,
                                      self.far))
            self.poses = np.stack(poses)
            self.image_paths = paths
            self.all_rays = np.concatenate(rays, 0).astype(np.float32)
            self.all_rgbs = np.concatenate(rgbs, 0).astype(np.float32)

    def __len__(self):
        if self.split == "train":
            return len(self.all_rays)
        if self.split == "val":
            return min(self.val_num, len(self.meta["frames"]))
        return len(self.meta["frames"])

    def __getitem__(self, idx: int):
        if self.split == "train":
            return {"rays": self.all_rays[idx], "rgbs": self.all_rgbs[idx]}
        frame = self.meta["frames"][idx]
        c2w = np.array(frame["transform_matrix"], dtype=np.float32)[:3, :4]
        path = os.path.join(self.root_dir, f"{frame['file_path']}.png")
        img = _load_image(path, self.img_wh, self.black_and_white)
        valid_mask = img[:, 3] > 0
        rgbs = img[:, :3] if self.black_and_white else blend_rgba(img)
        rays = make_rays(self.directions, c2w, self.near, self.far)
        return {
            "rays": rays,
            "rgbs": rgbs.astype(np.float32),
            "c2w": c2w,
            "valid_mask": valid_mask,
        }
