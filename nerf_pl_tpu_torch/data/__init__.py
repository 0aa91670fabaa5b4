"""Dataset loaders (``nerf_pl_tpu/data``): host numpy buffers of rays and
colours; the trainer moves them to the device once.

``dataset_dict`` holds every loader of the JAX package: ``blender``,
``llff`` and the four shadow loaders (``efficient_sm``, ``rgb_sm``,
``pyredner2`` per ray, ``shadows`` per image)."""
from __future__ import annotations

from .blender import BlenderDataset
from .blender_efficient_sm import BlenderEfficientShadows
from .blender_rgb_shadows import BlenderRGBEfficientShadows
from .blender_shadows import BlenderDatasetShadows
from .llff import LLFFDataset
from .pyredner2 import PyRednerShadowsDataset

dataset_dict = {"blender": BlenderDataset,
                "llff": LLFFDataset,
                "shadows": BlenderDatasetShadows,
                "efficient_sm": BlenderEfficientShadows,
                "rgb_sm": BlenderRGBEfficientShadows,
                "pyredner2": PyRednerShadowsDataset}

__all__ = ["dataset_dict"]
