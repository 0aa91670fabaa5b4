#!/bin/bash
# Blender-lego baseline (the reference's recipe, README.md:75-83; cf.
# legos_baseline.sh) on the port's trainer; extra flags go last.
python -m nerf_pl_tpu_torch.train \
  --dataset_name blender --root_dir "${DATA_DIR:-/data/nerf_synthetic/lego}" \
  --img_wh 400 400 --N_samples 64 --N_importance 64 \
  --batch_size 1024 --num_epochs 16 \
  --optimizer adam --lr 5e-4 --lr_scheduler steplr \
  --decay_step 2 4 8 --decay_gamma 0.5 \
  --exp_name lego_baseline "$@"
