#!/usr/bin/env bash
# Train a spatial-control LoRA (canny / sr / fill / subject / cartoon) with
# the PyTorch port on the CUDA cards of one host, one process a card.
# Usage: CONFIG=configs/canny_512.yaml NGPUS=2 scripts/train_spatial_torch.sh
set -euo pipefail
NGPUS=${NGPUS:-$(nvidia-smi --list-gpus | wc -l)}
torchrun --standalone --nproc-per-node "${NGPUS}" \
  -m loongx_tpu_torch.cli.train \
  --config "${CONFIG:-configs/canny_512.yaml}" \
  "$@"
