#!/bin/bash
# The reference's SLURM grid as a dispatcher, on the port's trainers: each
# case runs the same flags, in the same order, as the same case of the JAX
# package's recipe table (mapped from the reference's root-level scripts),
# on python -m nerf_pl_tpu_torch.<trainer>, with any extra flags last.
#   DATA_DIR=/path/to/scene nerf_pl_tpu_torch/launchers/recipes.sh <recipe> \
#     [extra flags, e.g. --device cpu]
# The trainers run on the card unless given --device cpu.  Recipes that
# resume a run read its checkpoint from CKPT.
set -euo pipefail
RECIPE="${1:?usage: recipes.sh <recipe> [extra flags] (see the case list in this file)}"
shift
cd "$(dirname "$0")/../.."
case "$RECIPE" in
  128Bunny_500_cont)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name 64x64_resulst_500v2_BUNNY_sigma150_on_sm2_2gpu --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  128Statue_2gpu_SIGMA150)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name statue_800_sigma_150_128x128_sm2_run1 --num_sanity_val_steps 1 --Light_N_importance 64 --grad_on_light --batch_size 512 "$@" ;;
  128Vase_500_scratch_sigma0)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name 64x64_results_500_v2_scratch_sigma0_gradon_run3_2gpu --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  128_bunny_2gpu)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name 128x128_sigma100_bunny_grad_on_sm2_sigma_run1_2gpu --num_sanity_val_steps 1 --Light_N_importance 64 --grad_on_light --batch_size 512 "$@" ;;
  128_chairs)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name CHAIRS_sigma150_128x128_single_image_grad_on_sm2_sigma_run1_2gpu --num_sanity_val_steps 1 --Light_N_importance 64 --grad_on_light --batch_size 512 "$@" ;;
  128_egpytv3)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name EGPYTV3_changed_LTRANS_sigma150_128x128_single_image_grad_on_sm2_sigma_run1_2gpu --num_sanity_val_steps 1 --Light_N_importance 64 --grad_on_light --batch_size 512 "$@" ;;
  128_single_image_2gpu)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name 128x128_single_image_grad_on_sm2_sigma_run3_2gpu --num_sanity_val_steps 1 --Light_N_importance 64 --grad_on_light --batch_size 512 "$@" ;;
  128_single_image_2gpu_SIGMA30)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name SIGMA150_to_30_128x128_single_image_grad_on_sm2_sigma_run3_2gpu --num_sanity_val_steps 1 --Light_N_importance 64 --grad_on_light --batch_size 512 --ckpt_path "$CKPT" "$@" ;;
  128_single_image_2gpu_nosigma)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name 128x128_single_image_grad_on_sm2_no_sigma_run1_2gpu --num_sanity_val_steps 1 --Light_N_importance 64 --grad_on_light --batch_size 512 "$@" ;;
  128x128ManStatue)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name 128x128_UPDATED_LT_MANSTATUE_sigma_150_var_cam_run2 --num_sanity_val_steps 1 --Light_N_importance 64 --grad_on_light --batch_size 512 "$@" ;;
  128x128Statue_sig150)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name statue_800_sigma_150_128x128_sm2_nimp64_nsamp64 --num_sanity_val_steps 1 --Light_N_importance 64 --grad_on_light --batch_size 512 "$@" ;;
  128x128Vase)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name VASE_SIGMA150_128x128_sm2_nimp128_nsamp64_run1 --num_sanity_val_steps 1 --Light_N_importance 64 --grad_on_light --batch_size 512 "$@" ;;
  128x128bunny_run0)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name BUNNY_SIGMA100_var_cam_128x128_gradon_sm2_Nimp64_run0 --num_sanity_val_steps 1 --Light_N_importance 64 --grad_on_light --batch_size 512 "$@" ;;
  64Egypt_500)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name EGPYT_SIGMA_150_64x64_run2 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64Egypt_500_s50)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name EGPYT_SIGMA_50_64x64_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64Vase_500_s50)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name VASE_SIGMA_50_64x64_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64Vase_cont_best)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name 64x64_results_500_v2_64Vase_sigma150to50_e55 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  64Vase_cont_best2)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 500 --optimizer adam --lr 0.00001 --exp_name 64x64_results_500_v2_64Vase_sigma150to50_e279 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  64Vase_cont_best_500_50_0)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 500 --optimizer adam --lr 0.00001 --exp_name 64x64_results_500_v2_64Vase_sigma150to50to0_e499 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  64x64Bunny)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 500 --optimizer adam --lr 0.00001 --exp_name UPDATED_LT_BUNNY_SIGMA150_scratch_run1_cont --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Bunny_s0_from50_150)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 550 --optimizer adam --lr 0.00001 --exp_name BUNNY_SIGMA_0_from50_150_scratch_64x64_sm2_nimp128_nsamp64_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  64x64Bunny_s30)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name UPDATED_LT_BUNNY_SIGMA150_to50_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Bunny_s50)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 500 --optimizer adam --lr 0.00001 --exp_name UPDATED_LT_BUNNY_SIGMA150_to50_run2 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Chair)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name CHAIR_sigma150_var_cam_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Chair_run2)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name CHAIR_sigma150_var_cam_run1_nsamples128 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Chair_s30)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --num_epochs 500 --optimizer adam --lr 0.00001 --exp_name CHAIR_sigma_50to30_var_cam_run2_e52 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  64x64Chair_s50)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 500 --optimizer adam --lr 0.00001 --exp_name CHAIR_sigma_50_var_cam_run2_e52 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  64x64Egpy_v3)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name egyptv2_sigma150 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Egpy_v3_s50)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name egyptv2_sigma_50 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Empire)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --num_epochs 300 --exp_name EMPIRE_sigma150_var_cam_run2 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64ManECCV)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.0001 --exp_name ECCV_sigma150_var_cam_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64ManECCV_s0)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 500 --optimizer adam --lr 0.0001 --exp_name ECCV_sigma_30_var_cam_run2 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  64x64ManECCV_s50)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 500 --optimizer adam --lr 0.0001 --exp_name ECCV_sigma_50_var_cam_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  64x64ManStatue)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.0001 --exp_name UPDATED_LT_MANSTATUE_sigma150_var_cam_run2 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64ManStatue_s0)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --num_epochs 500 --optimizer adam --lr 0.00001 --exp_name UPDATED_LT_MANSTATUE_sigma_0_var_cam_run2 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  64x64ManStatue_s50)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.0001 --exp_name UPDATED_LT_MANSTATUE_sigma_50_var_cam_run2 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Results_500_lightinside)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --use_disp --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name RAY_TERM_ONLY_light_inside_sigma_150_64x64_sm2_nimp128_nsamp64_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64SPhere)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 500 --optimizer adam --lr 0.00001 --exp_name UPDATED_LT_SPHERE_SIGMA_50_to_0_64x64_run1_e8_cont --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  64x64SPhere_s50)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 500 --optimizer adam --lr 0.00001 --exp_name UPDATED_LT_SPHERE_SIGMA_50_64x64_run1_e8_cont --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  64x64Statue800_150)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name statue_800_sigma_150_64x64_sm2_nimp128_nsamp64_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Statue800_50)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name statue_800_sigma_50_64x64_sm2_nimp128_nsamp64_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Statue800_50_to_0)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 500 --optimizer adam --lr 0.00001 --exp_name statue_800_sigma_50_to_0_64x64_sm2_nimp128_nsamp64_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  64x64Statue_150)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name statue_200_sigma_REAL150_64x64_sm2_nimp128_nsamp64_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Statue_50)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name statue_200_sigma150_64x64_sm2_nimp128_nsamp64_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  64x64VWvan)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name VW_SIGMA150_64x64_sm2_nimp128_nsamp64_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64VWvan_s50)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name VW_SIGMA_50_64x64_sm2_nimp128_nsamp64_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Vase)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --use_disp --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name RAY_TERM_ONLY_VASE_SIGMA150_64x64_sm2_nimp128_nsamp64_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Vase_lower_pres)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name LP_VASE_sigma150_var_cam_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64Vase_scratch)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --use_disp --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name VASE_SIGMA0_scratch_64x64_sm2_nimp128_nsamp64_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64_3Cuboid-1)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name 3Cuboid_SIGMA150_64x64_sm2_nimp128_nsamp128 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 "$@" ;;
  64x64_lower_pers)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name LOWER_PRES_VASE_SIGMA150_64x64_sm2_nimp128_nsamp128_run1 --num_sanity_val_steps 1 --Light_N_importance 128 --grad_on_light --batch_size 4096 --ckpt_path "$CKPT" "$@" ;;
  actual_128Vase_500_cont)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 128 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name 128x128_resulst_500v2_vase_sigma0_on_sm2_2gpu --num_sanity_val_steps 1 --Light_N_importance 64 --grad_on_light --batch_size 512 --ckpt_path "$CKPT" "$@" ;;
  legos_128)
    python -m nerf_pl_tpu_torch.train_rgb_sm_juntos --root_dir "$DATA_DIR" --dataset_name rgb_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 200 --batch_size 512 --optimizer adam --lr 0.00001 --exp_name legos/128x128_Nimp64_LN32_grad_on_bluroff --Light_N_importance 32 --shadow_method shadow_method_2 --grad_on_light "$@" ;;
  legos_baseline)
    python -m nerf_pl_tpu_torch.train_rgb_sm_juntos --root_dir "$DATA_DIR" --dataset_name rgb_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 200 --batch_size 512 --optimizer adam --lr 0.00001 --exp_name legos/baseline_128x128_Nimp64_LN0_grad_off_bluroff_smw0 --Light_N_importance 0 --shadow_method shadow_method_2 --sm_weight 0.0 "$@" ;;
  legos_sm_64)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 200 --batch_size 4096 --optimizer adam --lr 0.00001 --exp_name legos/sm_only_Nimp128_64x64_LN64_sm2_blur0 --num_sanity_val_steps 1 --Light_N_importance 64 --shadow_method shadow_method_2 --grad_on_light "$@" ;;
  legos_weigths_200)
    python -m nerf_pl_tpu_torch.train_rgb_sm_juntos --root_dir "$DATA_DIR" --dataset_name rgb_sm --N_importance 64 --N_samples 64 --img_wh 200 200 --noise_std 0 --num_epochs 300 --batch_size 512 --optimizer adam --lr 0.00001 --exp_name legos/200x200_Nimp64_LN32_sm2_grad_off_bluroff --Light_N_importance 32 --shadow_method shadow_method_2 --sm_weight 1.0 --rgb_weight 2.0 "$@" ;;
  ray_term_128_single_image_2gpu)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name RAY_TERM_ONLY_128x128_single_image_grad_on_sm2_sigma_run3_2gpu --num_sanity_val_steps 1 --Light_N_importance 64 --grad_on_light --batch_size 512 "$@" ;;
  rgb_sm_sigma_64)
    python -m nerf_pl_tpu_torch.train_rgb_sm_juntos --root_dir "$DATA_DIR" --dataset_name rgb_sm --N_importance 64 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 200 --batch_size 4096 --optimizer adam --lr 0.00001 --exp_name sigma/sigma_150_Nimp_64_64x64_grad_on_light_LN_32_sm2 --num_sanity_val_steps 1 --Light_N_importance 32 --shadow_method shadow_method_2 --grad_on_light "$@" ;;
  rgb_sm_submit)
    python -m nerf_pl_tpu_torch.train_rgb_sm_juntos --root_dir "$DATA_DIR" --dataset_name rgb_sm --N_importance 128 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --batch_size 512 --optimizer adam --lr 0.00001 --exp_name sigma/sigma_light_inside_Nimp128_128x128_grad_on_LN32_sm2_blur5 --num_sanity_val_steps 1 --grad_on_light --Light_N_importance 32 --shadow_method shadow_method_2 --blur 5 "$@" ;;
  rgb_sm_submit_200)
    python -m nerf_pl_tpu_torch.train_rgb_sm_juntos --root_dir "$DATA_DIR" --dataset_name rgb_sm --N_importance 128 --N_samples 64 --img_wh 200 200 --noise_std 0 --num_epochs 200 --batch_size 128 --optimizer adam --lr 0.00001 --exp_name Nimp_128_200x200_grad_on_light_LN_32_shadowmethod2_blur_10_1 --num_sanity_val_steps 1 --grad_on_light --Light_N_importance 32 --shadow_method shadow_method_2 --blur 10 "$@" ;;
  rgb_sm_submit_sigma_150)
    python -m nerf_pl_tpu_torch.train_rgb_sm_juntos --root_dir "$DATA_DIR" --dataset_name rgb_sm --N_importance 128 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 200 --batch_size 512 --optimizer adam --lr 0.00001 --exp_name sigma/sigma_150_Nimp_128_128x128_grad_on_light_LN_32_shadowmethod2_2 --num_sanity_val_steps 1 --grad_on_light --Light_N_importance 32 --shadow_method shadow_method_2 "$@" ;;
  sigma_150)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 300 --optimizer adam --lr 0.00001 --exp_name sigma/128x128_Nimp64_LN32_sm1_white_only --Light_N_importance 32 --shadow_method shadow_method_1 --grad_on_light --batch_size 1024 "$@" ;;
  sigma_150_submit)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --batch_size 4096 --optimizer adam --lr 0.00001 --exp_name sigma/Nimp_64_64x64_grad_on_light_LN_32_shadowmethod1_onlywhite_pix --Light_N_importance 32 --shadow_method shadow_method_1 --grad_on_light --white_pix 0.95 "$@" ;;
  sigma_150_submit_128)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 200 --batch_size 1024 --optimizer adam --lr 0.00001 --exp_name NEW_2__SIGMA_Nimp_64_128x128_grad_on_light_LN_32_shadowmethod2 --Light_N_importance 32 --shadow_method shadow_method_2 --grad_on_light "$@" ;;
  single_image)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 300 --batch_size 4096 --optimizer adam --lr 0.00001 --exp_name single_image_grad_on_sm2_no_sigma --num_sanity_val_steps 1 --Light_N_importance 64 --shadow_method shadow_method_2 "$@" ;;
  submit)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 128 --img_wh 64 64 --noise_std 0 --num_epochs 200 --batch_size 4096 --optimizer adam --lr 0.00001 --exp_name Nimp_64_64x64_grad_on_light_LN_32_shadowmethod1_blur2_whitepix_only --Light_N_importance 64 --shadow_method shadow_method_1 --blur 2 --grad_on_light --white_pix 0.0 "$@" ;;
  submit_128)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 200 --batch_size 256 --optimizer adam --lr 0.00001 --exp_name Nimp128_128x128_grad_on_light_LN_64_sm1_blur2_whitepix_only --Light_N_importance 64 --shadow_method shadow_method_1 --blur 2 --grad_on_light --white_pix 0.0 "$@" ;;
  submit_128_sm2)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 128 128 --noise_std 0 --num_epochs 200 --batch_size 1024 --chunk 32768 --optimizer adam --lr 0.00001 --exp_name Nimp_128_128x128_grad_off_light_LN_16_shadowmethod2_blur_run3 --Light_N_importance 32 --shadow_method shadow_method_2 --blur 2 "$@" ;;
  submit_no_grad)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 128 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 200 --batch_size 4096 --optimizer adam --lr 0.00001 --exp_name Nimp_128_64x64_grad_on_light_LN_64_shadowmethod1_blur_run3 --Light_N_importance 64 --shadow_method shadow_method_1 --blur 2 "$@" ;;
  submit_sm2)
    python -m nerf_pl_tpu_torch.train_efficient_sm --root_dir "$DATA_DIR" --dataset_name efficient_sm --N_importance 64 --N_samples 64 --img_wh 64 64 --noise_std 0 --num_epochs 200 --batch_size 4096 --optimizer adam --lr 0.00001 --exp_name Nimp_64_64x64_grad_on_light_LN_32_shadowmethod2_blur_run3_1 --Light_N_importance 32 --shadow_method shadow_method_2 --blur 2 --grad_on_light "$@" ;;
  *)
    echo "unknown recipe: $RECIPE (see the case list in this file)" >&2; exit 2 ;;
esac
