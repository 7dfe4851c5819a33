#!/usr/bin/env bash
# Quality evaluation over generated vs ground-truth pairs with the PyTorch
# port's evaluate CLI (the counterpart of scripts/test.sh).  The port's own
# CPU tests: python -m pytest tests/test_torch_*.py -q
set -euo pipefail
python -m loongx_tpu_torch.cli.evaluate \
  --gen_dir "${GEN_DIR:?set GEN_DIR}" \
  --gt_dir "${GT_DIR:-$GEN_DIR}" \
  --clip_path "${CLIP_PATH:-}" \
  --dino_path "${DINO_PATH:-}" \
  --out_dir "${OUT_DIR:-eval_results}" \
  "$@"
