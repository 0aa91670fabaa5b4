"""PyRedner shadow dataset, registry name ``pyredner2``
(``nerf_pl_tpu/data/pyredner2.py``; reference ``datasets/pyredner2.py``).

The per-ray layout of ``efficient_sm``, from another scene format:
  * each pose is a ``{"eye_pos", "camera"}`` dict; the rays' c2w is the
    look-at from the eye toward ``meta["look_at"]``, while the stored
    ``camera`` PPC is used verbatim for the shadow projection (the light's
    too);
  * ``coords_trans`` (or ``coords_trans2``, which picks the other flip)
    right-multiplies the c2w with a coordinate flip;
  * each frame names its target in ``sm_file_path``;
  * the blur has a fixed radius of 5 whenever ``blur != 0``, the default of
    -1 included, as the reference's truthiness test does;
  * ``white_back = True``; near/far = light near/far = 1/200.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..models.camera import c2w_from_lookat
from .shadow_common import (LightRig, get_ray_directions, load_sm_image,
                            make_rays, pixel_grid)

# x right, y in, z up -> x right, y up, z out (and the variant of
# coords_trans2)
_COORD_TRANS_DEFAULT = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32)
_COORD_TRANS_2 = np.diag(np.array([1, -1, -1, 1], np.float32))


class PyRednerShadowsDataset:
    white_back = True

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        img_wh=(800, 800),
        coords_trans: bool = False,
        coords_trans2: bool = False,
        blur: int = -1,
        val_num: int = 8,
        near: float = 1.0,
        far: float = 200.0,
        light_near: float = 1.0,
        light_far: float = 200.0,
    ):
        if img_wh[0] != img_wh[1]:
            raise ValueError("image width must equal image height!")
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.blur = 5 if int(blur) != 0 else -1
        self.val_num = val_num
        self.near, self.far = near, far
        self.light_near, self.light_far = light_near, light_far
        self._ct = _COORD_TRANS_2 if coords_trans2 else _COORD_TRANS_DEFAULT
        self.coords_trans = coords_trans or coords_trans2
        self._read_meta()

    def _c2w(self, eye_pos: np.ndarray) -> np.ndarray:
        c2w = c2w_from_lookat(
            eye_pos, np.asarray(self.meta["look_at"], np.float32))[:3, :4]
        if self.coords_trans:
            c2w = c2w @ self._ct
        return c2w

    def _sm_path(self, frame) -> str:
        path = frame["sm_file_path"]
        return path if os.path.isabs(path) else os.path.join(self.root_dir, path)

    def _read_meta(self):
        with open(os.path.join(self.root_dir, f"transforms_{self.split}.json")) as f:
            self.meta = json.load(f)
        w, h = self.img_wh
        self.focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        self.focal *= w / 800.0
        self.directions = get_ray_directions(h, w, self.focal)
        self.pixels = pixel_grid(w, h)
        lm = self.meta["light_camera_transform_matrix"]
        light_eye = np.asarray(lm["eye_pos"], np.float32)
        light_cam = np.asarray(lm["camera"], np.float32)
        self.light = LightRig(
            self.img_wh, self.meta["light_camera_angle_x"], self._c2w(light_eye),
            self.light_near, self.light_far,
            camera_override=light_cam, eye_override=light_eye)
        if self.split != "train":
            return
        rays, rgbs, pose_idx, cam_ms, cam_eyes = [], [], [], [], []
        for frame in self.meta["frames"]:
            sm_path = self._sm_path(frame)
            if not os.path.exists(sm_path):
                continue
            eye = np.asarray(frame["transform_matrix"]["eye_pos"], np.float32)
            cam = np.asarray(frame["transform_matrix"]["camera"], np.float32)
            p = len(cam_ms)
            cam_ms.append(cam)
            cam_eyes.append(eye)
            rgbs.append(load_sm_image(sm_path, self.img_wh, self.blur))
            rays.append(make_rays(self.directions, self._c2w(eye), self.near,
                                  self.far))
            pose_idx.append(np.full(h * w, p, np.int32))
        self.cam_ms = np.stack(cam_ms)
        self.cam_eyes = np.stack(cam_eyes)
        self.all_rays = np.concatenate(rays, 0)
        self.all_rgbs = np.concatenate(rgbs, 0)
        self.all_pixels = np.tile(self.pixels, (len(cam_ms), 1))
        self.pose_idx = np.concatenate(pose_idx, 0)

    def __len__(self):
        if self.split == "train":
            return len(self.all_rays)
        if self.split == "val":
            return min(self.val_num, len(self.meta["frames"]))
        return len(self.meta["frames"])

    def __getitem__(self, idx: int):
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
        eye = np.asarray(frame["transform_matrix"]["eye_pos"], np.float32)
        cam = np.asarray(frame["transform_matrix"]["camera"], np.float32)
        return {
            "rays": make_rays(self.directions, self._c2w(eye), self.near,
                              self.far),
            "pixels": self.pixels,
            "rgbs": load_sm_image(self._sm_path(frame), self.img_wh, self.blur),
            "ppc": {"eye_pos": eye, "camera": cam},
            **self.light.items(),
        }
