#!/usr/bin/env bash
# Real-weights / real-data mIoU gate of the PyTorch/CUDA port (the twin of
# scripts/run_accuracy_gate.sh; ready to run once the assets exist, none
# of which ships with the repository).
#
# Assets needed (reference README.md:28-89):
#   $CKPT  = model_large_retrieval_flickr.pth  (BLIP-ITM-Large, LAVIS)
#   $VOCAB = bert-base-uncased vocab.txt
#   $DATA  = dataset root: VOCdevkit/VOC2012/... + GPT4o_classification/
#            (the GPT caches ship with the reference repo)
# Runs on the card; DEVICE=cpu runs the plain PyTorch versions instead.
set -euo pipefail
CKPT=${CKPT:?set CKPT=/path/model_large_retrieval_flickr.pth}
VOCAB=${VOCAB:?set VOCAB=/path/vocab.txt}
DATA=${DATA:?set DATA=/path/data_root}
OUT=${OUT:-/tmp/pnp_gate_torch}

python scripts/accuracy_gate_torch.py \
  --checkpoint "$CKPT" --vocab "$VOCAB" --home_dir "$DATA" \
  --save_path "$OUT" --data_type voc --device "${DEVICE:-cuda}" "$@"
