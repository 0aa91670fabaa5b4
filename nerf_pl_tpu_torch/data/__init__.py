"""Dataset loaders (``nerf_pl_tpu/data``): host numpy buffers of rays and
colours; the trainer moves them to the device once.

``dataset_dict`` holds the loaders ported so far: ``blender`` and the
per-ray shadow loader ``efficient_sm``.  The LLFF loader and the other
shadow loaders come with later slices (ROADMAP.md, Queue 1)."""
from __future__ import annotations

from .blender import BlenderDataset
from .blender_efficient_sm import BlenderEfficientShadows

dataset_dict = {"blender": BlenderDataset,
                "efficient_sm": BlenderEfficientShadows}

__all__ = ["dataset_dict"]
