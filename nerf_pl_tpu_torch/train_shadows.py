"""Train an RGB NeRF on a shadow dataset with the port (the counterpart of
``train_shadows.py``): the vanilla step on the loader's rays.

    python -m nerf_pl_tpu_torch.train_shadows --dataset_name shadows \
        --root_dir <scene> --img_wh 64 64 --N_samples 64 --N_importance 64 \
        --num_epochs 16 --batch_size 1024 --lr 5e-4 --exp_name shadows_64 \
        [--device cuda|cpu]

Every flag of ``train_shadows.py`` parses as it does there; ``--device``
(default ``cuda``) is the port's own.
"""
from __future__ import annotations

from .training.launch import launch
from .training.shadow_systems import ShadowsSystem


def main(argv=None) -> ShadowsSystem:
    return launch(ShadowsSystem, argv=argv)


if __name__ == "__main__":
    main()
