#!/usr/bin/env python3
"""One served W8A8 neural edit on one CUDA card, its image saved as .npy:
the FLUX.1-dev serving bundle (random int8 weights from seed 0) or, with
``--hidream``, HiDream-I1's; a 512x512 request drawn from seed 1, served
twice (the second image must equal the first bit for bit, and the second
request must change no weight's layout).  ``--package DIR`` imports
loongx_tpu_torch from another checkout, so that two trees' images can be
compared bit for bit (``scripts/wgmma_check.py image``).

    python3 scripts/serve_image.py OUT.npy [--hidream] [--steps N] [--package DIR]
"""

import argparse
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--hidream", action="store_true")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--package", default=None)
    args = ap.parse_args()
    root = Path(args.package or Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from loongx_tpu_torch.models.flux.vae import VAEConfig
    from loongx_tpu_torch.models.hidream.model import HiDreamConfig
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.sampling import generate

    if not torch.cuda.is_available():
        sys.exit("serve_image: no CUDA device")
    cfg = HiDreamConfig.hidream_i1() if args.hidream else None
    pipe = LoongXPipeline.init_serving(cfg, VAEConfig.flux(), seed=0)
    rng = np.random.default_rng(1)
    req = dict(cond_image=(rng.random((512, 512, 3)) * 255).astype(np.uint8),
               eeg=rng.standard_normal((1, 4, 4096)).astype(np.float32),
               ppg=rng.standard_normal((1, 4, 256)).astype(np.float32),
               fnirs=rng.standard_normal((1, 6, 512)).astype(np.float32),
               motion=rng.standard_normal((1, 6, 128)).astype(np.float32),
               seed=1, num_inference_steps=args.steps, w8a8=True)
    if args.hidream:
        g = torch.Generator(device="cuda").manual_seed(1)
        req.update(text_streams=torch.randn(1, 48, 128, 4096, device="cuda", generator=g)
                   .to(torch.bfloat16),
                   pooled_extra=torch.randn(1, 1280, device="cuda", generator=g))
    images, layout = [], []
    for _ in range(2):
        cuda_build.LAUNCHES.clear()
        images.append(generate.neural_edit(pipe, **req))
        layout.append({k: v for k, v in cuda_build.LAUNCHES.items()
                       if k.startswith("w8a8_layout")})
    np.save(args.out, images[0])
    same = np.array_equal(images[0], images[1])
    print(f"serve_image {'HiDream-I1' if args.hidream else 'FLUX.1-dev'} from {root}: "
          f"{args.steps} steps, image {images[0].shape} sum {float(images[0].sum())!r}, "
          f"second request equal {same}, layout changes by request {layout} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return 0 if same and not layout[1] else 1


if __name__ == "__main__":
    sys.exit(main())
