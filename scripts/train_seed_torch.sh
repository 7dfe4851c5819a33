#!/usr/bin/env bash
# Train the L-Mind neural-editing LoRA with the PyTorch port on the CUDA
# cards of one host: one process a card, started by torchrun.  The config's
# mesh says how many cards split the DiT (tensor); the rest split each
# global batch (data).  NGPUS=1 trains on one card.
set -euo pipefail
NGPUS=${NGPUS:-$(nvidia-smi --list-gpus | wc -l)}
torchrun --standalone --nproc-per-node "${NGPUS}" \
  -m loongx_tpu_torch.cli.train \
  --config "${XFL_CONFIG:-configs/seed_512.yaml}" \
  "$@"
