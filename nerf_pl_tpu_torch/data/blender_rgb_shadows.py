"""Joint RGB + shadow-map dataset, registry name ``rgb_sm``
(``nerf_pl_tpu/data/blender_rgb_shadows.py``; reference
``datasets/blender_rgb_shadows.py``).

The per-ray layout of ``efficient_sm``, with both targets on every ray:
``all_rgbs`` is the RGBA photo blended over white and ``all_sm`` the shadow
map.  Kept from the reference:
  * ``max_images`` keeps a random subset of the frames, shuffled with
    ``np.random.RandomState(seed)`` (other splits keep 25), then only the
    frames with an ``sm_<name>.png`` target;
  * ``white_back = True``; near/far = light near/far = 1/200;
  * the focal from the fixed original width of 800.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .blender import _load_image, blend_rgba
from .sharding import wrap_pad_shard
from .shadow_common import (LightRig, get_ray_directions, load_sm_image,
                            make_rays, pixel_grid, posed_ppc, sm_path_for)


class BlenderRGBEfficientShadows:
    white_back = True

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        img_wh=(800, 800),
        max_images: int = 100,
        blur: int = -1,
        val_num: int = 8,
        near: float = 1.0,
        far: float = 200.0,
        light_near: float = 1.0,
        light_far: float = 200.0,
        seed: int = 0,
        frame_shard=None,
    ):
        if img_wh[0] != img_wh[1]:
            raise ValueError("image width must equal image height!")
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.max_images = max_images if split == "train" else 25
        self.blur = int(blur)
        self.val_num = val_num
        self.near, self.far = near, far
        self.light_near, self.light_far = light_near, light_far
        # (offset, step): this host reads kept[offset::step], wrap-padded;
        # the pose tables stay whole and pose_idx global
        self.frame_shard = frame_shard
        self.seed = seed
        self._read_meta()

    def _has_sm(self, frame) -> bool:
        return os.path.exists(sm_path_for(self.root_dir, frame["file_path"]))

    def _photo(self, frame) -> np.ndarray:
        name = frame["file_path"].split("/")[-1]
        img = _load_image(os.path.join(self.root_dir, f"{name}.png"), self.img_wh)
        return blend_rgba(img).astype(np.float32)

    def _read_meta(self):
        with open(os.path.join(self.root_dir, f"transforms_{self.split}.json")) as f:
            self.meta = json.load(f)
        w, h = self.img_wh
        self.focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        self.focal *= w / 800.0
        self.directions = get_ray_directions(h, w, self.focal)
        self.pixels = pixel_grid(w, h)
        l2w = np.array(
            self.meta["light_camera_transform_matrix"], dtype=np.float32
        )[:3, :4]
        self.light = LightRig(self.img_wh, self.meta["light_camera_angle_x"],
                              l2w, self.light_near, self.light_far)

        if self.max_images != -1:
            rng = np.random.RandomState(self.seed)
            rng.shuffle(self.meta["frames"])
            self.meta["frames"] = self.meta["frames"][: self.max_images]
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
        rays, rgbs, sms, pose_idx = [], [], [], []
        local = list(range(len(kept)))
        if self.frame_shard is not None:
            local = wrap_pad_shard(local, self.frame_shard)
        for p in local:
            frame = kept[p]
            rgbs.append(self._photo(frame))
            sms.append(load_sm_image(sm_path_for(self.root_dir, frame["file_path"]),
                                     self.img_wh, self.blur))
            rays.append(make_rays(self.directions, poses[p], self.near, self.far))
            pose_idx.append(np.full(h * w, p, np.int32))
        self.all_rays = np.concatenate(rays, 0)
        self.all_rgbs = np.concatenate(rgbs, 0).astype(np.float32)
        self.all_sm = np.concatenate(sms, 0)
        self.all_pixels = np.tile(self.pixels, (len(rays), 1))
        self.pose_idx = np.concatenate(pose_idx, 0)

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
                "sm": self.all_sm[idx],
                "ppc": {"eye_pos": self.cam_eyes[p], "camera": self.cam_ms[p]},
            }
        frame = self.meta["frames"][idx]
        c2w = np.array(frame["transform_matrix"], dtype=np.float32)[:3, :4]
        M, eye = posed_ppc(self.meta["camera_angle_x"], (w, h), c2w)
        return {
            "rays": make_rays(self.directions, c2w, self.near, self.far),
            "pixels": self.pixels,
            "rgbs": self._photo(frame),
            "sm": load_sm_image(sm_path_for(self.root_dir, frame["file_path"]),
                                self.img_wh, self.blur),
            "ppc": {"eye_pos": eye, "camera": M},
            **self.light.items(),
        }
