"""Dataset loaders (``nerf_pl_tpu/data``): host numpy buffers of rays and
colours; the trainer moves them to the device once.

``dataset_dict`` holds the loaders ported so far: ``blender`` and the four
shadow loaders (``efficient_sm``, ``rgb_sm``, ``pyredner2`` per ray,
``shadows`` per image).  The LLFF loader comes with a later slice
(ROADMAP.md, Queue 1)."""
from __future__ import annotations

from .blender import BlenderDataset
from .blender_efficient_sm import BlenderEfficientShadows
from .blender_rgb_shadows import BlenderRGBEfficientShadows
from .blender_shadows import BlenderDatasetShadows
from .pyredner2 import PyRednerShadowsDataset

dataset_dict = {"blender": BlenderDataset,
                "shadows": BlenderDatasetShadows,
                "efficient_sm": BlenderEfficientShadows,
                "rgb_sm": BlenderRGBEfficientShadows,
                "pyredner2": PyRednerShadowsDataset}

__all__ = ["dataset_dict"]
