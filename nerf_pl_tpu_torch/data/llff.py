"""LLFF, real forward-facing or spheric scenes (``nerf_pl_tpu/data/llff.py``;
reference ``datasets/llff.py``), on host numpy arrays.

  * ``poses_bounds.npy``: each row a 3x5 pose (the last column ``H, W,
    focal``) and 2 depth bounds; the focal scaled to ``img_wh``.
  * The poses turned from COLMAP's "down right back" to "right up back",
    centred by the inverse of their average pose (``average_poses``,
    ``center_poses``), then scaled so the nearest bound sits at 1/0.75.
  * The val image is the pose closest to the centre; ``val_num`` repeats it.
  * Forward-facing scenes: NDC rays (``get_ndc_rays``) with near 0 and far 1;
    ``spheric_poses``: world rays, near the least bound and far
    ``min(8 near, max bound)``.
  * Test paths: a 120-pose spiral (forward-facing) or circle (spheric);
    ``split="test_train"`` renders the training poses.  Only ``val`` has
    ground truth.
  * ``images/*`` are any image Pillow reads in a container the port reads,
    told apart by their content as ``Image.open`` tells them
    (``data/image.py``), converted to RGB and resized to ``img_wh`` with
    PIL's LANCZOS (``data/resize.py``), each bit-equal to Pillow's; any
    other format raises naming the file.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from .image import convert, read_picture
from .resize import resize_lanczos
from .sharding import wrap_pad_shard
from .shadow_common import get_ndc_rays, get_ray_directions, get_rays


def normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """(N, 3, 4) -> (3, 4) average pose (centre, mean z, mean y, their
    cross products)."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray):
    pose_avg = average_poses(poses)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    last_row = np.tile(np.array([0, 0, 0, 1]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = np.linalg.inv(pose_avg_homo) @ poses_homo
    return poses_centered[:, :3], np.linalg.inv(pose_avg_homo)


def create_spiral_poses(radii, focus_depth, n_poses: int = 120) -> np.ndarray:
    poses_spiral = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = normalize(center - np.array([0, 0, -focus_depth]))
        y_ = np.array([0, 1, 0])
        x = normalize(np.cross(y_, z))
        y = np.cross(z, x)
        poses_spiral.append(np.stack([x, y, z, center], 1))
    return np.stack(poses_spiral, 0)


def create_spheric_poses(radius, n_poses: int = 120) -> np.ndarray:
    def spheric_pose(theta, phi, radius):
        trans_t = np.array(
            [[1, 0, 0, 0], [0, 1, 0, -0.9 * radius], [0, 0, 1, radius],
             [0, 0, 0, 1]])
        rot_phi = np.array(
            [[1, 0, 0, 0],
             [0, np.cos(phi), -np.sin(phi), 0],
             [0, np.sin(phi), np.cos(phi), 0],
             [0, 0, 0, 1]])
        rot_theta = np.array(
            [[np.cos(theta), 0, -np.sin(theta), 0],
             [0, 1, 0, 0],
             [np.sin(theta), 0, np.cos(theta), 0],
             [0, 0, 0, 1]])
        c2w = rot_theta @ rot_phi @ trans_t
        c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                        [0, 0, 0, 1]]) @ c2w
        return c2w[:3]

    return np.stack([spheric_pose(th, -np.pi / 5, radius)
                     for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]], 0)


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8: PIL's ``Image.open(path).convert("RGB")``."""
    return convert(read_picture(path), "RGB")


def _load_rgb(path, img_wh):
    img = read_image(path)
    assert img.shape[0] * img_wh[0] == img.shape[1] * img_wh[1], (
        f"{path} has different aspect ratio than img_wh, please check your "
        "data!")
    img = resize_lanczos(img, "RGB", img_wh)
    return (img.astype(np.float32) / 255.0).reshape(-1, 3)


class LLFFDataset:
    white_back = False

    def __init__(self, root_dir: str, split: str = "train", img_wh=(504, 378),
                 spheric_poses: bool = False, val_num: int = 1,
                 frame_shard=None):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.spheric_poses = spheric_poses
        self.val_num = max(1, val_num)
        self.frame_shard = frame_shard
        self._read_meta()

    def _rays_for(self, c2w: np.ndarray) -> np.ndarray:
        rays_o, rays_d = get_rays(self.directions, c2w.astype(np.float32))
        if not self.spheric_poses:
            near, far = 0.0, 1.0
            rays_o, rays_d = get_ndc_rays(
                self.img_wh[1], self.img_wh[0], self.focal, 1.0, rays_o, rays_d)
        else:
            near = self.bounds.min()
            far = min(8 * near, self.bounds.max())
        nf = np.ones_like(rays_o[:, :1])
        return np.concatenate([rays_o, rays_d, near * nf, far * nf],
                              1).astype(np.float32)

    def _read_meta(self):
        poses_bounds = np.load(os.path.join(self.root_dir, "poses_bounds.npy"))
        self.image_paths = sorted(glob.glob(os.path.join(self.root_dir,
                                                         "images/*")))
        if self.split in ["train", "val"]:
            assert len(poses_bounds) == len(self.image_paths), (
                "Mismatch between number of images and number of poses! "
                "Please rerun COLMAP!")
        poses = poses_bounds[:, :15].reshape(-1, 3, 5)
        self.bounds = poses_bounds[:, -2:]

        H, W, self.focal = poses[0, :, -1]
        assert H * self.img_wh[0] == W * self.img_wh[1], (
            f"You must set @img_wh to have the same aspect ratio as "
            f"({W}, {H}) !")
        self.focal *= self.img_wh[0] / W

        poses = np.concatenate(
            [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
        self.poses, self.pose_avg = center_poses(poses)
        distances = np.linalg.norm(self.poses[..., 3], axis=1)
        val_idx = int(np.argmin(distances))
        self.val_idx = val_idx

        near_original = self.bounds.min()
        scale_factor = near_original * 0.75
        self.bounds /= scale_factor
        self.poses[..., 3] /= scale_factor

        self.directions = get_ray_directions(self.img_wh[1], self.img_wh[0],
                                             self.focal)

        if self.split == "train":
            train_idx = [i for i in range(len(self.image_paths))
                         if i != val_idx]
            if self.frame_shard is not None:
                train_idx = wrap_pad_shard(train_idx, self.frame_shard,
                                           what="images")
            rays, rgbs = [], []
            for i in train_idx:
                rgbs.append(_load_rgb(self.image_paths[i], self.img_wh))
                rays.append(self._rays_for(self.poses[i]))
            self.all_rays = np.concatenate(rays, 0)
            self.all_rgbs = np.concatenate(rgbs, 0)
        elif self.split == "val":
            self.c2w_val = self.poses[val_idx]
            self.image_path_val = self.image_paths[val_idx]
        else:
            if self.split.endswith("train"):
                self.poses_test = self.poses
            elif not self.spheric_poses:
                focus_depth = 3.5
                radii = np.percentile(np.abs(self.poses[..., 3]), 90, axis=0)
                self.poses_test = create_spiral_poses(radii, focus_depth)
            else:
                radius = 1.1 * self.bounds.min()
                self.poses_test = create_spheric_poses(radius)

    def __len__(self):
        if self.split == "train":
            return len(self.all_rays)
        if self.split == "val":
            return self.val_num
        return len(self.poses_test)

    def __getitem__(self, idx: int):
        if self.split == "train":
            return {"rays": self.all_rays[idx], "rgbs": self.all_rgbs[idx]}
        c2w = self.c2w_val if self.split == "val" else self.poses_test[idx]
        sample = {"rays": self._rays_for(c2w), "c2w": c2w.astype(np.float32)}
        if self.split == "val":
            sample["rgbs"] = _load_rgb(self.image_path_val, self.img_wh)
            sample["valid_mask"] = np.ones(self.img_wh[0] * self.img_wh[1],
                                           bool)
        return sample
