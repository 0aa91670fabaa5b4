"""Train the joint RGB + shadow-map system with the port (the counterpart of
``train_rgb_sm_juntos.py``): loss = rgb_weight * MSE(rgb) + sm_weight *
MSE(sm).

    python -m nerf_pl_tpu_torch.train_rgb_sm_juntos --dataset_name rgb_sm \
        --root_dir <scene> --img_wh 64 64 --N_samples 64 --N_importance 64 \
        --noise_std 0 --num_epochs 200 --batch_size 4096 --optimizer adam \
        --lr 1e-5 --grad_on_light --Light_N_importance 32 \
        --shadow_method shadow_method_2 --exp_name rgb_sm_64 [--device cuda|cpu]

Every flag of ``train_rgb_sm_juntos.py`` parses as it does there; ``--device``
(default ``cuda``) is the port's own.
"""
from __future__ import annotations

from .training.launch import launch
from .training.shadow_systems import RGBSMSystem


def main(argv=None) -> RGBSMSystem:
    return launch(RGBSMSystem, argv=argv)


if __name__ == "__main__":
    main()
