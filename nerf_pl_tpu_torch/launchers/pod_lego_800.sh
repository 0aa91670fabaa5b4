#!/bin/bash
# Multi-host 800x800 Blender run (BASELINE config 5), rays sharded over every
# card of every host, followed by the coloured mesh on rank 0.
#
# Run it as each worker of a torchrun group, on every host:
#   torchrun --nnodes <hosts> --nproc_per_node <cards> --node_rank <i> \
#     --rdzv_endpoint <host0>:<port> --no-python \
#     nerf_pl_tpu_torch/launchers/pod_lego_800.sh
# torchrun gives each worker RANK, WORLD_SIZE and the group's address;
# --multihost makes the trainer join that group (one rank a card, NCCL), the
# data layer shards the rays by host (--per_host_data), the parameters are
# replicated and the grads all-reduced every step.
set -e
DATA="${DATA_DIR:-/data/nerf_synthetic/lego}"

python -m nerf_pl_tpu_torch.train \
  --dataset_name blender --root_dir "$DATA" \
  --img_wh 800 800 --N_samples 64 --N_importance 128 \
  --batch_size 4096 --num_epochs 16 \
  --optimizer adam --lr 5e-4 --lr_scheduler steplr \
  --decay_step 2 4 8 --decay_gamma 0.5 \
  --compute_dtype bfloat16 --multihost --per_host_data \
  --exp_name pod_lego_800 "$@"

# the coloured mesh of the trained scene, on rank 0 only (its sigma grid on
# that rank's card, triangulation and colour fusion on the host)
if [ "${RANK:-0}" = 0 ]; then
  python -m nerf_pl_tpu_torch.extract_color_mesh \
    --root_dir "$DATA" --dataset_name blender --scene_name pod_lego_800 \
    --img_wh 800 800 --N_grid 256 --sigma_threshold 20 \
    --x_range -1.2 1.2 --y_range -1.2 1.2 --z_range -1.2 1.2 \
    --ckpt_path "ckpts/pod_lego_800/epoch=15.ckpt"
fi
