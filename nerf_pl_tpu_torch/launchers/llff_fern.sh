#!/bin/bash
# LLFF forward-facing (the reference's recipe, README.md:104-112) on the
# port's trainer; extra flags go last.
python -m nerf_pl_tpu_torch.train \
  --dataset_name llff --root_dir "${DATA_DIR:-/data/nerf_llff_data/fern}" \
  --img_wh 504 378 --N_samples 64 --N_importance 64 \
  --batch_size 1024 --num_epochs 30 \
  --optimizer adam --lr 5e-4 --lr_scheduler steplr \
  --decay_step 10 20 --decay_gamma 0.5 \
  --exp_name fern "$@"
