#!/usr/bin/env bash
# Convert HF FLUX.1 + T5 + CLIP + VAE safetensors into a pipeline directory
# of the PyTorch port (loongx_tpu_torch.cli.convert).
set -euo pipefail
python -m loongx_tpu_torch.cli.convert \
  --flux "${FLUX_PATH:?path to FLUX.1 safetensors dir}" \
  --t5 "${T5_PATH:?}" --clip "${CLIP_PATH:?}" --vae "${VAE_PATH:?}" \
  --out "${OUT:-checkpoints/flux-dev-torch}" \
  "$@"
