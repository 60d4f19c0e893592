#!/bin/bash
# Reference Calculate_mIoU.sh equivalent on the PyTorch/CUDA port (host
# only: it sums the hist files the port's segmentation CLI wrote).
set -e
python -m pnp_ovss_tpu_torch.evalx.aggregate --save_path "${1:?save_path}" --data_type "${2:?data_type}"
