"""Dataset loaders (``nerf_pl_tpu/data``): host numpy buffers of rays and
colours; the trainer moves them to the device once.

``dataset_dict`` holds the loaders ported so far: ``blender``.  The LLFF and
shadow loaders come with later slices (ROADMAP.md, Queue 1)."""
from __future__ import annotations

from .blender import BlenderDataset

dataset_dict = {"blender": BlenderDataset}

__all__ = ["dataset_dict"]
