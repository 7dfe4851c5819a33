#!/usr/bin/env bash
# Batch neural-driven editing with the PyTorch port on the CUDA cards of
# one host: one process a card, started by torchrun.  TENSOR cards split
# the DiT (tensor parallelism); the rest split each group's images (data
# parallelism).  NGPUS=1 TENSOR=1 serves on one card.
set -euo pipefail
NGPUS=${NGPUS:-$(nvidia-smi --list-gpus | wc -l)}
torchrun --standalone --nproc-per-node "${NGPUS}" \
  -m loongx_tpu_torch.cli.infer \
  --tensor "${TENSOR:-1}" \
  --checkpoint "${CHECKPOINT:?set CHECKPOINT=<pipeline dir from loongx_tpu_torch.cli.convert>}" \
  --input_dir "${INPUT_DIR:?set INPUT_DIR}" \
  --output_dir "${OUTPUT_DIR:-outputs}" \
  --caption_path "${CAPTION_PATH:-}" \
  --brain_data_path "${BRAIN_DATA:-}" \
  "$@"
