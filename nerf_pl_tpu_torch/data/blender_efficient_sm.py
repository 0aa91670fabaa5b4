"""Per-ray shadow-map dataset, registry name ``efficient_sm``
(``nerf_pl_tpu/data/blender_efficient_sm.py``; reference
``datasets/blender_efficient_sm.py``).

The train split is one flattened buffer over the frames that have an
``sm_<name>.png`` target:
  * ``all_rays (N, 8)``, ``all_pixels (N, 3)`` = [x+.5, y+.5, 1] and
    ``all_rgbs (N, 3)``, the shadow-map target;
  * ``pose_idx (N,) int32`` into the ``cam_ms (P,3,3)`` / ``cam_eyes (P,3)``
    tables (the reference keeps a ``Camera`` per ray);
  * the shared light rig: ``light.rays (H*W, 8)``, ``light.pixels``,
    ``light.camera``, ``light.eye_pos``.

Kept from the reference: the original-resolution meta key ``resolution``
(default 800); near/far = light near/far = 1/200; the ``white_pix``
bright-pixel filter; the ``blur`` pre-blur; val frames filtered to those
with a shadow map; ``white_back``.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .sharding import wrap_pad_shard
from .shadow_common import (LightRig, get_ray_directions, load_sm_image,
                            make_rays, pixel_grid, posed_ppc, sm_path_for)


class BlenderEfficientShadows:
    white_back = True

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        img_wh=(800, 800),
        white_pix: float = -1.0,
        blur: int = -1,
        val_num: int = 8,
        near: float = 1.0,
        far: float = 200.0,
        light_near: float = 1.0,
        light_far: float = 200.0,
        frame_shard=None,
    ):
        if img_wh[0] != img_wh[1]:
            raise ValueError("image width must equal image height!")
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.white_pix = float(white_pix)
        self.blur = int(blur)
        self.val_num = val_num
        self.near, self.far = near, far
        self.light_near, self.light_far = light_near, light_far
        # (offset, step): this host reads kept[offset::step], wrap-padded;
        # the pose tables stay whole and pose_idx global
        self.frame_shard = frame_shard
        self._read_meta()

    def _has_sm(self, frame) -> bool:
        return os.path.exists(sm_path_for(self.root_dir, frame["file_path"]))

    def _read_meta(self):
        with open(os.path.join(self.root_dir, f"transforms_{self.split}.json")) as f:
            self.meta = json.load(f)
        w, h = self.img_wh
        res = self.meta.get("resolution", 800)
        self.focal = 0.5 * res / np.tan(0.5 * self.meta["camera_angle_x"])
        self.focal *= w / res
        self.directions = get_ray_directions(h, w, self.focal)
        self.pixels = pixel_grid(w, h)
        l2w = np.array(
            self.meta["light_camera_transform_matrix"], dtype=np.float32
        )[:3, :4]
        self.light = LightRig(self.img_wh, self.meta["light_camera_angle_x"],
                              l2w, self.light_near, self.light_far,
                              base_res=res)

        if self.split == "val":
            self.meta["frames"] = [f for f in self.meta["frames"]
                                   if self._has_sm(f)]
        if self.split != "train":
            return
        kept = [f for f in self.meta["frames"] if self._has_sm(f)]
        cam_ms, cam_eyes, poses = [], [], []
        for frame in kept:
            c2w = np.array(frame["transform_matrix"], dtype=np.float32)[:3, :4]
            M, eye = posed_ppc(self.meta["camera_angle_x"], (w, h), c2w)
            cam_ms.append(M)
            cam_eyes.append(eye)
            poses.append(c2w)
        self.poses = np.stack(poses)
        self.cam_ms = np.stack(cam_ms)
        self.cam_eyes = np.stack(cam_eyes)
        rays, rgbs, pose_idx = [], [], []
        local = list(range(len(kept)))
        if self.frame_shard is not None:
            local = wrap_pad_shard(local, self.frame_shard)
        for p in local:
            frame = kept[p]
            sm_path = sm_path_for(self.root_dir, frame["file_path"])
            rgbs.append(load_sm_image(sm_path, self.img_wh, self.blur))
            rays.append(make_rays(self.directions, poses[p], self.near,
                                  self.far))
            pose_idx.append(np.full(h * w, p, np.int32))
        self.all_rays = np.concatenate(rays, 0)
        self.all_rgbs = np.concatenate(rgbs, 0)
        self.all_pixels = np.tile(self.pixels, (len(rays), 1))
        self.pose_idx = np.concatenate(pose_idx, 0)
        if self.white_pix != -1.0:
            keep = self.all_rgbs.sum(axis=1) / 3.0 > self.white_pix
            self.all_rays = self.all_rays[keep]
            self.all_rgbs = self.all_rgbs[keep]
            self.all_pixels = self.all_pixels[keep]
            self.pose_idx = self.pose_idx[keep]

    def __len__(self):
        if self.split == "train":
            return len(self.all_rays)
        if self.split == "val":
            return min(self.val_num, len(self.meta["frames"]))
        return len(self.meta["frames"])

    def __getitem__(self, idx: int):
        w, h = self.img_wh
        if self.split == "train":
            p = self.pose_idx[idx]
            return {
                "rays": self.all_rays[idx],
                "pixels": self.all_pixels[idx],
                "rgbs": self.all_rgbs[idx],
                "ppc": {"eye_pos": self.cam_eyes[p], "camera": self.cam_ms[p]},
                **self.light.items(),
            }
        frame = self.meta["frames"][idx]
        c2w = np.array(frame["transform_matrix"], dtype=np.float32)[:3, :4]
        M, eye = posed_ppc(self.meta["camera_angle_x"], (w, h), c2w)
        sm = load_sm_image(sm_path_for(self.root_dir, frame["file_path"]),
                           self.img_wh, self.blur)
        return {
            "rays": make_rays(self.directions, c2w, self.near, self.far),
            "pixels": self.pixels,
            "rgbs": sm,
            "ppc": {"eye_pos": eye, "camera": M},
            **self.light.items(),
        }
