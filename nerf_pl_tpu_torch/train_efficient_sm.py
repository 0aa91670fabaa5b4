"""Train the flagship shadow-mapping system with the port (the counterpart
of ``train_efficient_sm.py``).

    python -m nerf_pl_tpu_torch.train_efficient_sm --dataset_name efficient_sm \
        --root_dir <scene> --img_wh 64 64 --N_samples 64 --N_importance 64 \
        --noise_std 0 --num_epochs 200 --batch_size 1024 --optimizer adam \
        --lr 1e-5 --grad_on_light --Light_N_importance 32 \
        --shadow_method shadow_method_2 --exp_name eff_sm_64 [--device cuda|cpu]

Every flag of ``train_efficient_sm.py`` parses as it does there; ``--device``
(default ``cuda``) is the port's own.  ``--dataset_name`` takes
``efficient_sm`` and ``pyredner2``, as the JAX script does.
"""
from __future__ import annotations

from .training.launch import launch
from .training.shadow_systems import EfficientSMSystem


def main(argv=None) -> EfficientSMSystem:
    return launch(EfficientSMSystem, allowed_datasets=("efficient_sm", "pyredner2"),
                  argv=argv)


if __name__ == "__main__":
    main()
