#!/usr/bin/env python3
"""The port's float32 convolutions on the card under two precision settings,
against the CPU.  Needs one CUDA card.

    python3 scripts/precision_check.py

Setting "default" is PyTorch's own at start-up, which the CLIs ran under
before they called `loongx_tpu_torch.precision.set_precision` (cuDNN free
to use TF32); setting "set_precision" is that function's.  Under each:

  * the depth estimator (random Depth-Anything-Small, ``chip_smoke``'s
    Hugging Face checkout, seed 21) on a 512x512 image (seed 31): its
    predicted depth against the same estimator on the CPU, max |diff| over
    max |CPU| (chip_smoke's DEPTH_REL_TOL bound);
  * the Whisper-large encoder at full width with 2 + 2 layers, float32, on
    chip_smoke's 5 s tone (its frontend convolutions included): the same
    ratio against the CPU (chip_smoke's WHISPER_ENC_REL_TOL bound).

Prints the card, both settings' flags and each error beside its bound, and
one JSON line last.  The checkout is written to a directory in the
checkout, removed at the end.
"""

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def flags():
    return {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}


def depth_err(est_gpu, est_cpu, image):
    got = est_gpu.predict_depth(image)
    want = est_cpu.predict_depth(image)
    return cs._rel_err(np, got, want)


def encoder_err(cpu, gpu, cfg2, feats):
    from loongx_tpu_torch.models.text import whisper

    want = whisper.whisper_encode(cpu, cfg2, feats)
    got = whisper.whisper_encode(gpu, cfg2, feats.to("cuda")).cpu()
    return float((got - want).abs().max() / want.abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("precision_check: no CUDA device", file=sys.stderr)
        return 2
    from PIL import Image
    from loongx_tpu_torch.cli import speech_demo
    from loongx_tpu_torch.models import depth
    from loongx_tpu_torch.models.text import whisper
    from loongx_tpu_torch.precision import set_precision
    from loongx_tpu_torch.utils.bridge import from_numpy_tree

    card = cs.card_line()
    print(f"card: {card}, torch {torch.__version__}", flush=True)
    root = tempfile.mkdtemp(prefix=".precision_check_", dir=ROOT)
    try:
        ddir = os.path.join(root, "depth-anything-small")
        cs.write_hf_depth(torch, ddir, depth.DepthAnythingConfig(),
                          torch.Generator(device="cuda").manual_seed(21), "cuda")
        est_gpu = depth.DepthAnythingEstimator.from_pretrained(ddir,
                                                               device="cuda")
        est_cpu = depth.DepthAnythingEstimator.from_pretrained(ddir,
                                                               device="cpu")
        image = Image.fromarray((np.random.default_rng(31).random(
            (512, 512, 3)) * 255).astype(np.uint8))

        wcfg = whisper.WhisperConfig.large()
        cfg2 = dataclasses.replace(wcfg, encoder_layers=2, decoder_layers=2)
        cpu = whisper.init_whisper_params(
            cfg2, generator=torch.Generator().manual_seed(5), device="cpu")
        gpu = from_numpy_tree(cpu, "cuda")
        wav, _ = cs.write_speech_inputs(root)
        filters = torch.from_numpy(whisper.mel_filter_bank(
            wcfg.n_fft // 2 + 1, wcfg.num_mel_bins, wcfg.sampling_rate,
            wcfg.sampling_rate / 2.0))
        feats = whisper.log_mel_spectrogram(torch.from_numpy(
            whisper.prepare_audio(speech_demo._read_audio(wav), wcfg)), cfg2,
            filters)

        result = {"card": card}
        for name in ("default", "set_precision"):
            if name == "set_precision":
                set_precision()
            t0 = time.perf_counter()
            d_err = depth_err(est_gpu, est_cpu, image)
            e_err = encoder_err(cpu, gpu, cfg2, feats)
            result[name] = {"flags": flags(), "depth_rel_err": d_err,
                            "depth_within": d_err <= cs.DEPTH_REL_TOL,
                            "encoder_rel_err": e_err,
                            "encoder_within": e_err <= cs.WHISPER_ENC_REL_TOL}
            print(f"{name}: {flags()}: depth max rel err {d_err:.3g} (bound "
                  f"{cs.DEPTH_REL_TOL}), Whisper encoder (2 layers, float32) "
                  f"{e_err:.3g} (bound {cs.WHISPER_ENC_REL_TOL}); "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
