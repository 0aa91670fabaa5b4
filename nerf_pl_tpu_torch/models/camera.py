"""Camera pose helpers (``nerf_pl_tpu/models/camera.py``; reference
``models/camera.py:50-67``).  Host-side numpy."""
from __future__ import annotations

import numpy as np


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
