"""Train the image-space shadow-mapping system with the port (the
counterpart of ``train_shadow_mapping.py``): whole camera and light depth
images composited per image; ``--batch_size`` counts images.

    python -m nerf_pl_tpu_torch.train_shadow_mapping --dataset_name shadows \
        --root_dir <scene> --img_wh 64 64 --N_samples 64 --N_importance 64 \
        --noise_std 0 --num_epochs 200 --batch_size 1 --lr 1e-5 \
        --shadow_method shadow_method_2 --exp_name sm_images_64 \
        [--device cuda|cpu]

Every flag of ``train_shadow_mapping.py`` parses as it does there; ``--device``
(default ``cuda``) is the port's own.
"""
from __future__ import annotations

from .training.launch import launch
from .training.shadow_systems import ShadowMappingSystem


def main(argv=None) -> ShadowMappingSystem:
    return launch(ShadowMappingSystem, argv=argv)


if __name__ == "__main__":
    main()
