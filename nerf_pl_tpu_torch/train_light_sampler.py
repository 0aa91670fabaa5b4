"""Train the sampled-light shadow system with the port (the counterpart of
``train_light_sampler.py``): light rays through the projected (ul, vl)
pixels of each batch instead of a cached whole light view.

    python -m nerf_pl_tpu_torch.train_light_sampler --dataset_name efficient_sm \
        --root_dir <scene> --img_wh 64 64 --N_samples 64 --N_importance 64 \
        --noise_std 0 --num_epochs 200 --batch_size 1024 --lr 1e-5 \
        --Light_N_importance 32 --shadow_method shadow_method_2 \
        --exp_name ls_64 [--device cuda|cpu]

Every flag of ``train_light_sampler.py`` parses as it does there; ``--device``
(default ``cuda``) is the port's own.
"""
from __future__ import annotations

from .training.launch import launch
from .training.shadow_systems import LightSamplerSystem


def main(argv=None) -> LightSamplerSystem:
    return launch(LightSamplerSystem, argv=argv)


if __name__ == "__main__":
    main()
