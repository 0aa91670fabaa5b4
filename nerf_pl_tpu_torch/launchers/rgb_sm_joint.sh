#!/bin/bash
# Joint RGB + shadow training (cf. the reference's rgb_sm_submit.sh family)
# on the port's trainer; extra flags go last.
python -m nerf_pl_tpu_torch.train_rgb_sm_juntos \
  --dataset_name rgb_sm --root_dir "${DATA_DIR:?set DATA_DIR}" \
  --img_wh 128 128 --N_samples 64 --N_importance 64 \
  --batch_size 1024 --num_epochs 200 \
  --optimizer adam --lr 5e-4 \
  --rgb_weight 1.0 --sm_weight 1.0 --blur 2 \
  --exp_name rgb_sm_joint "$@"
