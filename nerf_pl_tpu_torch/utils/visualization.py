"""Depth-map visualization (``nerf_pl_tpu/utils/visualization.py``;
reference ``utils/visualization.py:6-23``).

``visualize_depth``: nan→0, min-max normalize, apply a JET colormap, return
(3, H, W) float in [0, 1].  The reference shells out to OpenCV's
``COLORMAP_JET``; we evaluate the same piecewise-linear JET ramp in numpy so
the framework has no cv2 dependency.
"""
from __future__ import annotations

import numpy as np


def _jet(x: np.ndarray) -> np.ndarray:
    """OpenCV-style JET: x in [0,1] -> (..., 3) RGB in [0,1]."""
    x = np.clip(x, 0.0, 1.0)
    four = 4.0 * x
    r = np.clip(np.minimum(four - 1.5, -four + 4.5), 0.0, 1.0)
    g = np.clip(np.minimum(four - 0.5, -four + 3.5), 0.0, 1.0)
    b = np.clip(np.minimum(four + 0.5, -four + 2.5), 0.0, 1.0)
    return np.stack([r, g, b], axis=-1)


def visualize_depth(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth -> (3, H, W) JET-colored float image in [0, 1]."""
    x = np.nan_to_num(np.asarray(depth, dtype=np.float32))
    mi, ma = float(np.min(x)), float(np.max(x))
    x = (x - mi) / (ma - mi + 1e-8)
    rgb = _jet(x)
    return np.transpose(rgb, (2, 0, 1))
