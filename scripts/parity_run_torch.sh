#!/usr/bin/env bash
# Quality-parity run of the PyTorch port against the reference's published
# numbers (CLIP-I 0.6605 neural-only / CLIP-T 0.2588 neural+speech,
# +/- 0.005).  Fill in the paths on a host with the weights and the data.
#
#   FLUX_DIR   diffusers FLUX.1-dev checkout (transformer/ text_encoder/
#              text_encoder_2/ vae/ tokenizer/ tokenizer_2/)
#   CLIP_DIR   HF clip-vit-base-patch32 checkout (scoring backend)
#   DATA_DIR   L-Mind corpus root (test_s2t.jsonl, data_final.pkl, images)
#   LORA       (optional) trained LoongX LoRA safetensors
set -euo pipefail

FLUX_DIR=${FLUX_DIR:?set FLUX_DIR to a diffusers FLUX.1-dev checkout}
CLIP_DIR=${CLIP_DIR:?set CLIP_DIR to a clip-vit-base-patch32 checkout}
DATA_DIR=${DATA_DIR:?set DATA_DIR to the L-Mind corpus root}
LORA=${LORA:-}
OUT=${OUT:-parity_out_torch}
CKPT=${CKPT:-checkpoints/flux-dev-int8-torch}
EVAL_CLIP=${EVAL_CLIP:-checkpoints/eval_clip_torch}
MODE=${MODE:-neural}          # neural (CLIP-I row) | neural_speech (CLIP-T row)

# 1. convert + int8-quantize the pipeline once
if [ ! -f "$CKPT/config.json" ]; then
  python -m loongx_tpu_torch.cli.convert \
    --flux "$FLUX_DIR/transformer" \
    --t5 "$FLUX_DIR/text_encoder_2" \
    --clip "$FLUX_DIR/text_encoder" \
    --vae "$FLUX_DIR/vae" \
    --t5_tokenizer "$FLUX_DIR/tokenizer_2" \
    --clip_tokenizer "$FLUX_DIR/tokenizer" \
    --quantize --init-encoders \
    --out "$CKPT"
fi

# 2. convert the eval CLIP towers once
if [ ! -f "$EVAL_CLIP/eval_clip.pkl" ]; then
  python -m loongx_tpu_torch.cli.convert --eval_clip "$CLIP_DIR" --out "$EVAL_CLIP"
fi

# 3. generate over the test split + evaluate + compare (single command)
exec python -m loongx_tpu_torch.cli.parity \
  --checkpoint "$CKPT" \
  --test_jsonl "$DATA_DIR/test_s2t.jsonl" \
  --image_dir "$DATA_DIR" \
  --brain_data "$DATA_DIR/data_final.pkl" \
  --jax_clip_path "$EVAL_CLIP" \
  --out "$OUT" \
  --mode "$MODE" \
  --int8 --components flux,vae,encoders,dgf \
  ${LORA:+--lora "$LORA"}
