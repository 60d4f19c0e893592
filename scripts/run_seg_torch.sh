#!/bin/bash
# Reference Run_seg.sh equivalent (VOC / PSC / ADE20K) on the PyTorch/CUDA
# port: the flags of scripts/run_seg.sh, on pnp_ovss_tpu_torch.cli.segment.
# Usage: scripts/run_seg_torch.sh <data_type> <home_dir> <save_path> [checkpoint] [vocab]
# Runs on the card; DEVICE=cpu runs the plain PyTorch versions instead.
set -e
DATA_TYPE=${1:-voc}
HOME_DIR=${2:?home_dir required}
SAVE_PATH=${3:?save_path required}
CKPT=${4:+--checkpoint $4}
VOCAB=${5:+--vocab $5}
python -m pnp_ovss_tpu_torch.cli.segment \
  --data_type "$DATA_TYPE" --home_dir "$HOME_DIR" --save_path "$SAVE_PATH" \
  --img_size 336 --batch_size 35 \
  --max_att_block_num 8 --prune_att_head 9 \
  --drop_iter 4 --del_patch_num sort_thresh005 --sort_threshold 0.05 \
  --threshold 0.15 --postprocess blur+crf --device "${DEVICE:-cuda}" \
  $CKPT $VOCAB
