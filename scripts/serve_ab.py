#!/usr/bin/env python3
"""Served denoise ms/step with bf16 and with int8 QK^T scores, alternated,
on one CUDA card: the serving bundle (random weights from seed 0), one warm
request, then ``neural_edit`` (512x512, 28 steps, W8A8) three times in each
score mode, alternating, the denoise stage timed on the host clock around
work that ends in ``torch.cuda.synchronize()``.  For A/B calls of two
checkouts (run it from each); the step is host-bound, so compare medians
beside their spread.

    python3 scripts/serve_ab.py [label]
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from loongx_tpu_torch.models.pipeline import LoongXPipeline  # noqa: E402
from loongx_tpu_torch.sampling import generate  # noqa: E402

STEPS, REPS = 28, 3


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("serve_ab: no CUDA device")
    pipe = LoongXPipeline.init_serving(seed=0)
    rng = np.random.default_rng(1)
    req = dict(cond_image=(rng.random((512, 512, 3)) * 255).astype(np.uint8),
               eeg=rng.standard_normal((1, 4, 4096)).astype(np.float32),
               ppg=rng.standard_normal((1, 4, 256)).astype(np.float32),
               fnirs=rng.standard_normal((1, 6, 512)).astype(np.float32),
               motion=rng.standard_normal((1, 6, 128)).astype(np.float32),
               seed=1)
    denoise, seconds = generate.denoise, []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = denoise(*a, **k)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    generate.denoise = timed
    try:
        generate.neural_edit(pipe, **req, num_inference_steps=STEPS, w8a8=True)
        res = {"bf16": [], "int8": []}
        for _ in range(REPS):
            for mode in res:
                generate.neural_edit(pipe, **req, num_inference_steps=STEPS,
                                     w8a8=True, int8_attn=mode == "int8")
                res[mode].append(round(seconds[-1] / STEPS * 1e3, 1))
    finally:
        generate.denoise = denoise
    label = sys.argv[1] if len(sys.argv) > 1 else ""
    print(f"{label} ms/step {res} on {torch.cuda.get_device_name(0)}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
