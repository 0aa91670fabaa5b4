#!/bin/bash
# Efficient shadow mapping at 64x64 (cf. the reference's 64x64Statue_150.sh
# family) on the port's trainer; extra flags go last (--device cpu off the
# card).
python -m nerf_pl_tpu_torch.train_efficient_sm \
  --dataset_name efficient_sm --root_dir "${DATA_DIR:?set DATA_DIR}" \
  --img_wh 64 64 --N_samples 64 --N_importance 64 --noise_std 0 \
  --batch_size 1024 --num_epochs 200 \
  --optimizer adam --lr 1e-5 \
  --grad_on_light --Light_N_importance 32 \
  --shadow_method shadow_method_2 \
  --exp_name eff_sm_64 "$@"
