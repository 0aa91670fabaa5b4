"""Per-image shadow dataset, registry name ``shadows``
(``nerf_pl_tpu/data/blender_shadows.py``; reference
``datasets/blender_shadows.py``), read by the image-space shadow-mapping
trainer and by the RGB trainer on shadow data.

Each item is a whole image: its rays, its camera PPC, the ``sm_<name>.png``
target and the shared light rig.  Kept from the reference: camera near/far
1/200, light near/far **100/500**, ``white_back = False``, the focal from the
fixed original width of 800.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .shadow_common import (LightRig, get_ray_directions, load_sm_image,
                            make_rays, posed_ppc, sm_path_for)


class BlenderDatasetShadows:
    white_back = False

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        img_wh=(800, 800),
        val_num: int = 8,
        near: float = 1.0,
        far: float = 200.0,
        light_near: float = 100.0,
        light_far: float = 500.0,
    ):
        if img_wh[0] != img_wh[1]:
            raise ValueError("image width must equal image height!")
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.val_num = val_num
        self.near, self.far = near, far
        self.light_near, self.light_far = light_near, light_far
        self._read_meta()

    def _read_meta(self):
        with open(os.path.join(self.root_dir, f"transforms_{self.split}.json")) as f:
            self.meta = json.load(f)
        w, h = self.img_wh
        self.focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        self.focal *= w / 800.0
        self.directions = get_ray_directions(h, w, self.focal)
        l2w = np.array(
            self.meta["light_camera_transform_matrix"], dtype=np.float32
        )[:3, :4]
        self.light = LightRig(self.img_wh, self.meta["light_camera_angle_x"],
                              l2w, self.light_near, self.light_far)
        self.poses = [np.array(f["transform_matrix"], dtype=np.float32)[:3, :4]
                      for f in self.meta["frames"]]

    def __len__(self):
        if self.split == "val":
            return min(self.val_num, len(self.meta["frames"]))
        return len(self.meta["frames"])

    def __getitem__(self, idx: int):
        w, h = self.img_wh
        frame = self.meta["frames"][idx]
        c2w = self.poses[idx]
        M, eye = posed_ppc(self.meta["camera_angle_x"], (w, h), c2w)
        return {
            "rays": make_rays(self.directions, c2w, self.near, self.far),
            "rgbs": load_sm_image(sm_path_for(self.root_dir, frame["file_path"]),
                                  self.img_wh),
            "ppc": {"eye_pos": eye, "camera": M},
            "light_ppc": {"eye_pos": self.light.eye_pos,
                          "camera": self.light.camera},
            "light_rays": self.light.rays,
            "c2w": c2w,
        }
