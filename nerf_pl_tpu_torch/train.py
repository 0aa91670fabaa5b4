"""Train a vanilla NeRF with the port (the counterpart of ``train.py``).

    python -m nerf_pl_tpu_torch.train --dataset_name blender \
        --root_dir /data/lego --img_wh 400 400 --N_importance 64 \
        --num_epochs 16 --batch_size 1024 --lr 5e-4 --lr_scheduler steplr \
        --decay_step 2 4 8 --decay_gamma 0.5 --compute_dtype bfloat16 \
        --exp_name lego [--device cuda|cpu]

Every flag of ``train.py`` parses as it does there (``config.get_opts``);
``--device`` (default ``cuda``) is the port's own.  The config is written to
``<log_dir>/<exp_name>/config.json`` before training starts.
"""
from __future__ import annotations

from .training.launch import launch
from .training.trainer import NeRFSystem


def main(argv=None) -> NeRFSystem:
    return launch(NeRFSystem, argv=argv)


if __name__ == "__main__":
    main()
