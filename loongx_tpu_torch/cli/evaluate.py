"""Evaluation CLI, the reference's test.py / test.sh (counterpart of
``loongx_tpu/cli/evaluate.py``; every flag under the same name, plus
``--device``).

Usage:
  python -m loongx_tpu_torch.cli.evaluate --gen_dir outs [--gt_dir gts]
      [--jax_clip_path bundle | --clip_path /local/clip]
      [--jax_dino_path /local/dino | --dino_path /local/dino]
      [--caption_path test.jsonl] [--out_dir results] [--device cuda]

``--jax_clip_path`` and ``--jax_dino_path`` keep the JAX CLI's names so a
command written for it runs unchanged; here they select this package's own
towers (``evaluation/torch_backend.py``) on ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os


def load_instructions(caption_path):
    """{pair key: instruction} from a jsonl of source_image / speech2text /
    instruction rows (the pair key is the source's stem without ``_0``)."""
    if not (caption_path and os.path.exists(caption_path)):
        return None
    instructions = {}
    with open(caption_path, "r", encoding="utf-8") as f:
        for line in f:
            row = json.loads(line)
            name = os.path.splitext(
                row.get("source_image", "").split("/")[-1]
            )[0].removesuffix("_0")
            instructions[name] = (
                row.get("speech2text") or row.get("instruction", ""))
    return instructions


def load_clip_backend(bundle_dir: str, device="cuda"):
    """(image_embed, text_embed) from an ``eval_clip.pkl`` bundle directory
    (either package's ``cli.convert --eval_clip``) and its tokenizer."""
    import pickle

    from transformers import CLIPTokenizer

    from loongx_tpu_torch.evaluation.torch_backend import make_clip_backend
    from loongx_tpu_torch.models.text.clip import CLIPTextConfig
    from loongx_tpu_torch.models.text.clip_vision import CLIPVisionConfig

    # the bundle is this program's or the JAX package's own output
    with open(os.path.join(bundle_dir, "eval_clip.pkl"), "rb") as f:
        bundle = pickle.load(f)
    return make_clip_backend(
        bundle["text_params"], CLIPTextConfig(**bundle["text_cfg"]),
        bundle["vision_params"], CLIPVisionConfig(**bundle["vision_cfg"]),
        CLIPTokenizer.from_pretrained(bundle_dir), device=device)


def load_dino_backend(hf_dir: str, device="cuda"):
    """The DINO CLS embedder of a local HF ViT checkout, converted as it is
    read; the geometry comes from the weights (heads: hidden // 64)."""
    from loongx_tpu_torch.evaluation.torch_backend import make_dino_backend
    from loongx_tpu_torch.models.vision import ViTConfig
    from loongx_tpu_torch.utils.convert import (
        convert_vit_state, load_safetensors_dir,
    )

    state = {k.removeprefix("vit."): v
             for k, v in load_safetensors_dir(hf_dir).items()}
    n_layers = 1 + max(int(k.split(".")[2]) for k in state
                       if k.startswith("encoder.layer."))
    hidden = state["embeddings.cls_token"].numel()
    patch = state["embeddings.patch_embeddings.projection.weight"].shape[-1]
    ff = state["encoder.layer.0.intermediate.dense.weight"].shape[0]
    vcfg = ViTConfig(hidden=hidden, num_layers=n_layers,
                     num_heads=max(1, hidden // 64), patch_size=patch,
                     d_ff=ff)
    return make_dino_backend(convert_vit_state(state, vcfg, device=device),
                             vcfg, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(description="LoongX evaluation on "
                                     "PyTorch")
    parser.add_argument("--gen_dir", type=str, required=True)
    parser.add_argument("--gt_dir", type=str, default=None)
    parser.add_argument("--clip_path", type=str, default=None,
                        help="local HF CLIP checkpoint (Hugging Face "
                        "backend, on --device)")
    parser.add_argument("--jax_clip_path", type=str, default=None,
                        help="converted eval CLIP bundle (cli/convert "
                        "--eval_clip of either package); runs this "
                        "package's CLIP towers on --device.  The name is "
                        "the JAX CLI's")
    parser.add_argument("--dino_path", type=str, default=None,
                        help="local HF DINO checkpoint (Hugging Face "
                        "backend, on --device)")
    parser.add_argument("--jax_dino_path", type=str, default=None,
                        help="local HF DINO ViT dir converted as it is read; "
                        "runs this package's ViT on --device.  The name is "
                        "the JAX CLI's")
    parser.add_argument("--caption_path", type=str, default=None,
                        help="jsonl with instructions for CLIP-T")
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    from loongx_tpu_torch.precision import set_precision

    set_precision()

    import torch

    from loongx_tpu_torch.evaluation import evaluate_directory

    if torch.device(args.device).type == "cuda" and not (
            torch.cuda.is_available()):
        parser.error(f"--device {args.device}: no CUDA device is available "
                     "(pass --device cpu to run on the CPU)")
    img_fn = txt_fn = dino_fn = None
    if args.jax_clip_path:
        img_fn, txt_fn = load_clip_backend(args.jax_clip_path, args.device)
    if args.jax_dino_path:
        dino_fn = load_dino_backend(args.jax_dino_path, args.device)

    results = evaluate_directory(
        args.gen_dir,
        gt_dir=args.gt_dir,
        instructions=load_instructions(args.caption_path),
        clip_image_embed=img_fn,
        clip_text_embed=txt_fn,
        dino_image_embed=dino_fn,
        clip_path=args.clip_path,
        dino_path=args.dino_path,
        out_dir=args.out_dir,
        image_size=args.image_size,
        device=args.device,
    )
    for k, v in results.items():
        print(f"{k}: {v:.6f}")
    return results


if __name__ == "__main__":
    main()
