"""Weight conversion CLI: Hugging Face safetensors -> a pipeline directory
of this package (counterpart of ``loongx_tpu/cli/convert.py``).

Usage:
  python -m loongx_tpu_torch.cli.convert --flux <dir> --t5 <dir> \\
      --clip <dir> --vae <dir> --out checkpoints/flux-dev \\
      [--quantize [--serving]] [--init-encoders] [--schnell]

Each input dir holds the published safetensors of that component (the
``transformer/``, ``text_encoder_2/``, ``text_encoder/``, ``vae/`` subdirs of
a diffusers FLUX.1 checkpoint).  Tokenizer dirs are copied alongside when
given.  The conversion runs on ``--device`` (the GPU by default, where the
bf16 FLUX.1-dev tree fits; ``cpu`` otherwise); each source tensor is read
from its file and moved there on its own.  The output is the format of
`loongx_tpu_torch.utils.checkpoint`, not the JAX package's orbax one.
"""

from __future__ import annotations

import argparse
import shutil

from loongx_tpu_torch.cli.infer import _tree_has_key


def main(argv=None):
    import sys

    argv_list = list(argv) if argv is not None else sys.argv[1:]
    if "--eval_clip" in argv_list:
        raise SystemExit(
            "[convert] --eval_clip (the evaluation CLIP bundle) is not ported "
            "yet: it waits for the evaluation slice (ROADMAP.md Queue 1, "
            "Evaluation)")
    parser = argparse.ArgumentParser(description="Convert HF weights")
    parser.add_argument("--flux", type=str, required=True)
    parser.add_argument("--t5", type=str, required=True)
    parser.add_argument("--clip", type=str, required=True)
    parser.add_argument("--vae", type=str, required=True)
    parser.add_argument("--t5_tokenizer", type=str, default=None)
    parser.add_argument("--clip_tokenizer", type=str, default=None)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--schnell", action="store_true",
                        help="FLUX.1-schnell (no guidance embedder)")
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the conversion runs (default: the GPU; "
                        "'cpu' on a machine without one)")
    parser.add_argument(
        "--init-encoders", action="store_true",
        help="also write freshly-initialized full-size CS3 biosignal "
        "encoders + DGF fusion trees (drawn from a torch generator seeded "
        "with 0) as 'encoders'/'dgf' components, so the converted directory "
        "is a complete deployable pipeline for the neural-editing CLI (train "
        "or overwrite them afterwards)")
    parser.add_argument(
        "--quantize", action="store_true",
        help="int8-quantize the DiT + text encoders during conversion and "
        "save the quantized checkpoint (int8 FLUX.1-dev is about 12 GB)")
    parser.add_argument(
        "--serving", action="store_true",
        help="also bake the single-GPU serving transforms (fused qkv "
        "projections + single-block proj_out K-split) into the saved "
        "checkpoint, so serving starts with one load.  Not before LoRA "
        "attachment (adapters address q/k/v individually)")
    args = parser.parse_args(argv)

    import torch

    from loongx_tpu_torch.models.flux.model import FluxConfig
    from loongx_tpu_torch.models.flux.vae import VAEConfig
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.models.text.clip import CLIPTextConfig
    from loongx_tpu_torch.models.text.t5 import T5Config
    from loongx_tpu_torch.ops.quant import (
        fuse_qkv_projections, quantize_tree, split_single_proj_out,
    )
    from loongx_tpu_torch.utils.checkpoint import save_pipeline
    from loongx_tpu_torch.utils.convert import (
        convert_clip_state, convert_flux_state, convert_t5_state,
        convert_vae_state, load_safetensors_dir,
    )

    device = args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {device}: no CUDA device is available (pass "
                     "--device cpu to convert on the CPU)")
    dtype = getattr(torch, args.dtype)
    flux_cfg = (FluxConfig.flux_schnell() if args.schnell
                else FluxConfig.flux_dev())
    vae_cfg = VAEConfig.flux()
    t5_cfg = T5Config.xxl()
    clip_cfg = CLIPTextConfig.large()

    # each component is quantized as soon as it is converted: the same
    # result as converting all first, at a lower peak
    params = {}
    for name, src, convert, cfg, cdtype in (
            ("flux", args.flux, convert_flux_state, flux_cfg, dtype),
            ("vae", args.vae, convert_vae_state, vae_cfg, torch.float32),
            ("t5", args.t5, convert_t5_state, t5_cfg, dtype),
            ("clip", args.clip, convert_clip_state, clip_cfg, dtype)):
        print(f"[convert] {name} ...")
        params[name] = convert(load_safetensors_dir(src), cfg, cdtype,
                               device=device)
        if args.quantize and name != "vae":
            print(f"[convert] int8-quantize {name} ...")
            params[name] = quantize_tree(params[name])

    if args.serving:
        print("[convert] bake serving transforms ...")
        params["flux"] = split_single_proj_out(
            fuse_qkv_projections(params["flux"]), flux_cfg.hidden)
        # both transforms return the tree unchanged on unexpected layouts: a
        # convert run must not claim a serving checkpoint that still pays
        # the load-time reshuffle
        missing = [k for k in ("to_qkv", "proj_out_mlp")
                   if not _tree_has_key(params["flux"], k)]
        if missing:
            raise SystemExit(
                f"[convert] --serving failed to bake {missing}: the "
                "flux tree's q/k/v (or single-block proj_out) leaves "
                "are not in the expected layout — refusing to write a "
                "checkpoint that would still pay the load-time "
                "transform")

    if args.init_encoders:
        from loongx_tpu_torch.models.pipeline import _brain_params

        print("[convert] init CS3 encoders + DGF ...")
        gen = torch.Generator(device=device).manual_seed(0)
        params.update(_brain_params(dict(generator=gen, dtype=dtype,
                                         device=device)))

    pipe = LoongXPipeline(flux_cfg, vae_cfg, params, dtype, t5_cfg=t5_cfg,
                          clip_cfg=clip_cfg)
    save_pipeline(pipe, args.out)
    for name, src in (("t5_tokenizer", args.t5_tokenizer),
                      ("clip_tokenizer", args.clip_tokenizer)):
        if src:
            shutil.copytree(src, f"{args.out}/{name}", dirs_exist_ok=True)
    print(f"[convert] wrote {args.out}")


if __name__ == "__main__":
    main()
