#!/bin/bash
# Host-streaming slab-length sweep on the port's trainer (the counterpart
# of scripts/stream_slab_sweep.sh): the long-run protocol (a 64^2 Blender
# scene, batch 4096, N 64/128, bf16, cosine, validation every epoch) with
# the rays streamed from the native ray store (--data_device_resident
# false) in slabs of 8/16/32/64 steps, and the sustained rate of each
# (python -m nerf_pl_tpu_torch.scripts.sustained_rate).  Runs write under
# results/slab_sweep_<slab> of the repo root (the script runs from there).
#
#   nerf_pl_tpu_torch/scripts/stream_slab_sweep.sh <64px-blender-scene> [epochs]
#   DEVICE=cpu .../stream_slab_sweep.sh ...   # off the card (default cuda)
set -euo pipefail
SCENE="${1:?usage: stream_slab_sweep.sh <64px-blender-scene> [epochs]}"
EPOCHS="${2:-40}"
cd "$(dirname "$0")/../.."
DEVICE="${DEVICE:-cuda}"

for SLAB in 8 16 32 64; do
  OUT=results/slab_sweep_$SLAB
  rm -rf "$OUT"
  mkdir -p "$OUT"
  python -m nerf_pl_tpu_torch.train --root_dir "$SCENE" --dataset_name blender \
    --img_wh 64 64 --N_samples 64 --N_importance 128 --batch_size 4096 \
    --num_epochs "$EPOCHS" --lr 5e-4 --lr_scheduler cosine \
    --compute_dtype bfloat16 --blender_near 1 --blender_far 12 \
    --white_back true --noise_std 0 \
    --data_device_resident false --stream_slab_steps "$SLAB" \
    --num_sanity_val_steps 0 \
    --exp_name slab --log_dir "$OUT/logs" --ckpt_dir "$OUT/ckpts" \
    --device "$DEVICE" \
    > "$OUT.log" 2>&1
  echo -n "slab=$SLAB  "
  python -m nerf_pl_tpu_torch.scripts.sustained_rate \
    "$OUT/logs/slab/metrics.jsonl" --device "$DEVICE"
done
