"""Weight conversion CLI: Hugging Face safetensors -> a pipeline directory
of this package (counterpart of ``loongx_tpu/cli/convert.py``).

Usage:
  python -m loongx_tpu_torch.cli.convert --flux <dir> --t5 <dir> \\
      --clip <dir> --vae <dir> --out checkpoints/flux-dev \\
      [--quantize [--serving]] [--init-encoders] [--schnell]
  python -m loongx_tpu_torch.cli.convert --eval_clip <hf_clip_dir> --out <dir>

Each input dir holds the published safetensors of that component (the
``transformer/``, ``text_encoder_2/``, ``text_encoder/``, ``vae/`` subdirs of
a diffusers FLUX.1 checkpoint).  Tokenizer dirs are copied alongside when
given.  The conversion runs on ``--device`` (the GPU by default, where the
bf16 FLUX.1-dev tree fits; ``cpu`` otherwise); each source tensor is read
from its file and moved there on its own.  The output is the format of
`loongx_tpu_torch.utils.checkpoint`, not the JAX package's orbax one.

``--eval_clip`` converts a whole HF CLIP checkpoint (text + vision towers
and their projections) into the evaluation bundle ``eval_clip.pkl`` in the
JAX package's own format (numpy leaves in its layout, ``kernel`` [in, out],
the two config dicts) beside the copied tokenizer files: a bundle written by
either package's converter is read by either package's evaluate CLI.
"""

from __future__ import annotations

import argparse
import shutil

from loongx_tpu_torch.cli.infer import _tree_has_key


def convert_eval_clip(hf_dir: str, out_dir: str):
    """A full HF CLIP checkpoint (text + vision + projections) -> the
    evaluation bundle ``out_dir/eval_clip.pkl`` (see cli/evaluate
    --jax_clip_path) and the checkpoint's tokenizer files.  Runs on the
    CPU: the bundle holds numpy arrays."""
    import dataclasses
    import json
    import os
    import pickle

    import torch

    from loongx_tpu_torch.models.text.clip import CLIPTextConfig
    from loongx_tpu_torch.models.text.clip_vision import CLIPVisionConfig
    from loongx_tpu_torch.utils.bridge import to_numpy_tree
    from loongx_tpu_torch.utils.convert import (
        _lin, convert_clip_state, convert_clip_vision_state,
        load_safetensors_dir,
    )

    state = load_safetensors_dir(hf_dir)
    state = {k.removeprefix("text_model_with_projection."): v
             for k, v in state.items()}
    # head counts are not derivable from the weights: read config.json when
    # present (head_dim 64 is only a CLIP-L/B convention)
    heads = {}
    eos_id = None
    cfg_json = os.path.join(hf_dir, "config.json")
    if os.path.exists(cfg_json):
        with open(cfg_json) as f:
            hf_cfg = json.load(f)
        for part in ("text_config", "vision_config"):
            heads[part] = hf_cfg.get(part, {}).get("num_attention_heads")
        eos_id = hf_cfg.get("text_config", {}).get("eos_token_id")
    # the rest of the geometry from the weights
    tok = state["text_model.embeddings.token_embedding.weight"]
    hidden = tok.shape[1]
    n_text = len({k.split(".")[3] for k in state
                  if k.startswith("text_model.encoder.layers.")})
    text_cfg = CLIPTextConfig(
        vocab_size=tok.shape[0], hidden=hidden, num_layers=n_text,
        num_heads=heads.get("text_config") or max(1, hidden // 64),
        d_ff=state["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
        max_positions=state[
            "text_model.embeddings.position_embedding.weight"].shape[0],
        **({"eos_token_id": eos_id} if eos_id is not None else {}),
    )
    v_hidden = state["vision_model.embeddings.class_embedding"].numel()
    n_vis = len({k.split(".")[3] for k in state
                 if k.startswith("vision_model.encoder.layers.")})
    patch = state["vision_model.embeddings.patch_embedding.weight"].shape[-1]
    n_pos = state["vision_model.embeddings.position_embedding.weight"].shape[0]
    vision_cfg = CLIPVisionConfig(
        image_size=int(((n_pos - 1) ** 0.5) * patch), patch_size=patch,
        hidden=v_hidden, num_layers=n_vis,
        num_heads=heads.get("vision_config") or max(1, v_hidden // 64),
        d_ff=state["vision_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
        projection_dim=state["visual_projection.weight"].shape[0],
    )
    kw = dict(dtype=torch.float32, device="cpu")
    text_params = convert_clip_state(state, text_cfg, **kw)
    text_params["text_projection"] = _lin(state, "text_projection",
                                          bias=False, **kw)
    vision_params = convert_clip_vision_state(state, vision_cfg, **kw)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "eval_clip.pkl"), "wb") as f:
        pickle.dump({
            "text_params": to_numpy_tree(text_params),
            "text_cfg": dataclasses.asdict(text_cfg),
            "vision_params": to_numpy_tree(vision_params),
            "vision_cfg": dataclasses.asdict(vision_cfg),
        }, f)
    for name in ("vocab.json", "merges.txt", "tokenizer.json",
                 "tokenizer_config.json", "special_tokens_map.json"):
        src = os.path.join(hf_dir, name)
        if os.path.exists(src):
            shutil.copy(src, out_dir)
    print(f"[convert] wrote {out_dir}/eval_clip.pkl")


def main(argv=None):
    import sys

    # standalone eval-CLIP mode: --eval_clip <hf_dir> --out <dir>
    argv_list = list(argv) if argv is not None else sys.argv[1:]
    if "--eval_clip" in argv_list:
        hf_dir = argv_list[argv_list.index("--eval_clip") + 1]
        out = argv_list[argv_list.index("--out") + 1]
        convert_eval_clip(hf_dir, out)
        return
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
    from loongx_tpu_torch.precision import set_precision

    set_precision()

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
