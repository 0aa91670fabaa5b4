"""Pinhole camera (PPC) math (``nerf_pl_tpu/models/camera.py``; reference
``models/camera.py``).  Host-side numpy.

  * ``intrinsic_matrix``: ``M = [a, b, c]`` column-stacked with
    ``a = (1, 0, 0)``, ``b = (0, -1, 0)``, ``c = (-w/2, h/2,
    -w / (2 tan(hfov/2)))``;
  * ``pose_from_blender_matrix``: ``eye = c2w[:, 3]``, ``M <- c2w[:, :3] @ M``;
  * ``transformation_between``: ``R = M_to^-1 @ M_from``,
    ``Q = M_to^-1 @ (eye_from - eye_to)``, batched on leading axes;
  * ``Camera``: the reference's container over those functions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def intrinsic_matrix(hfov_deg: float, res: Tuple[int, int]) -> np.ndarray:
    """(3,3) M = [a, b, c] for a centred pinhole with horizontal FOV."""
    w, h = res
    hfov = float(hfov_deg) / 180.0 * np.pi
    a = np.array([1.0, 0.0, 0.0], dtype=np.float32)
    b = np.array([0.0, -1.0, 0.0], dtype=np.float32)
    c = np.array(
        [-w / 2.0, h / 2.0, -w / (2.0 * np.tan(hfov / 2.0))], dtype=np.float32
    )
    return np.stack([a, b, c]).T


def c2w_from_lookat(
    eye_pos: np.ndarray,
    look_at_point: np.ndarray,
    up_guidance: np.ndarray = np.array([0, 1, 0], dtype=np.float32),
) -> np.ndarray:
    """4x4 camera-to-world for an eye looking at a point."""
    back = eye_pos - look_at_point
    back = back / np.linalg.norm(back)
    right = np.cross(up_guidance, back)
    right = right / np.linalg.norm(right)
    up = np.cross(back, right)
    c2w = np.empty((4, 4), dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = back
    c2w[:3, 3] = eye_pos
    c2w[3, :] = [0, 0, 0, 1]
    return c2w


def pose_from_blender_matrix(
    M: np.ndarray, c2w: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(camera, eye_pos) after applying a (3,4) Blender c2w to intrinsics M."""
    eye_pos = np.asarray(c2w)[:, 3].astype(np.float32)
    camera = np.asarray(c2w)[:, :3].astype(np.float32) @ np.asarray(M, np.float32)
    return camera, eye_pos


def transformation_between(
    from_camera: np.ndarray,
    from_eye: np.ndarray,
    to_camera: np.ndarray,
    to_eye: np.ndarray,
):
    """R, Q for re-projecting from one PPC into another; inputs may carry
    leading batch axes."""
    ML_inv = np.linalg.inv(to_camera)
    Q = np.einsum("...ij,...j->...i", ML_inv, from_eye - to_eye)
    R = ML_inv @ from_camera
    return R, Q


@dataclasses.dataclass(eq=False)  # numpy fields: a generated __eq__ raises
class Camera:
    """The reference's PPC container (``models/camera.py:5``)."""

    camera: np.ndarray  # (3,3) column-stacked [a, b, c]
    eye_pos: Optional[np.ndarray] = None
    res: Optional[Tuple[int, int]] = None

    @classmethod
    def create(cls, hfov: float, res: Tuple[int, int]) -> "Camera":
        return cls(camera=intrinsic_matrix(hfov, res), res=tuple(res))

    @classmethod
    def from_camera_eyepos(cls, eye_pos, camera) -> "Camera":
        return cls(camera=np.asarray(camera), eye_pos=np.asarray(eye_pos))

    def get_a(self):
        return self.camera[:, 0]

    def get_b(self):
        return self.camera[:, 1]

    def get_c(self):
        return self.camera[:, 2]

    def set_pose_using_blender_matrix(self, c2w, transform_coords: bool = False):
        if transform_coords:
            raise ValueError("transform_coords is deprecated in the reference")
        self.camera, self.eye_pos = pose_from_blender_matrix(self.camera, c2w)

    def get_transformation_to(self, to_camera: "Camera"):
        return transformation_between(
            self.camera, self.eye_pos, to_camera.camera, to_camera.eye_pos
        )
