"""Quality-parity runbook (counterpart of ``loongx_tpu/cli/parity.py``):
one command from a converted pipeline directory to a PASS/FAIL against the
reference's published quality numbers.

The reference's parity claim is CLIP-I 0.6605 (neural signals only) and
CLIP-T 0.2588 (neural + speech) on the L-Mind test split, measured by its
metric harness (test.py, driven by test.sh).  This CLI chains the whole
pipeline on ``--device``:

  stage the split -> batch infer (cli/infer) -> evaluate (cli/evaluate)
  -> compare, written to ``<out>/parity.json``; exit 1 when it fails

  python -m loongx_tpu_torch.cli.parity \\
      --checkpoint checkpoints/flux-dev-int8 \\
      --lora runs/<run>/lora.safetensors \\
      --test_jsonl data/imagedataset/test_s2t.jsonl \\
      --image_dir data/imagedataset \\
      --brain_data data/imagedataset/data_final.pkl \\
      --jax_clip_path checkpoints/eval_clip \\
      --out parity_out [--mode neural|neural_speech] [--int8] ...

Stage mapping to the reference:
  - test-split staging = test.sh's gen/gt directory convention
    (generated ``<stem>_0`` pairs with ground-truth ``<stem>_1``)
  - batch infer = inference.py batch mode
  - evaluate = test.py metric suite (L1/L2, CLIP-I, CLIP-T, DINO)
  - compare = the published numbers within +/- tolerance
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys


def stage_test_split(test_jsonl, image_dir, out):
    """Copy the split's source frames (``*_0``) into ``out/inputs`` and the
    ground-truth targets (``*_1``) into ``out/gt``.  Returns file counts."""
    inputs = os.path.join(out, "inputs")
    gt = os.path.join(out, "gt")
    os.makedirs(inputs, exist_ok=True)
    os.makedirs(gt, exist_ok=True)
    n = 0
    with open(test_jsonl, "r", encoding="utf-8") as f:
        for line in f:
            row = json.loads(line)
            src = os.path.join(image_dir, row["source_image"])
            tgt = os.path.join(image_dir, row["target_image"])
            if not (os.path.exists(src) and os.path.exists(tgt)):
                print(f"[parity] missing pair for {row['source_image']} — "
                      "skipped")
                continue
            shutil.copy2(src, os.path.join(inputs, os.path.basename(src)))
            shutil.copy2(tgt, os.path.join(gt, os.path.basename(tgt)))
            n += 1
    if n == 0:
        raise SystemExit(f"[parity] no usable pairs in {test_jsonl}")
    print(f"[parity] staged {n} test pairs -> {inputs} / {gt}")
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="LoongX quality-parity runbook on PyTorch (batch infer "
        "over the L-Mind test split -> evaluate -> compare to the reference "
        "numbers)"
    )
    parser.add_argument("--checkpoint", required=True,
                        help="pipeline dir (loongx_tpu_torch.cli.convert; "
                        "--quantize there for the 12B one-GPU recipe)")
    parser.add_argument("--test_jsonl", required=True,
                        help="L-Mind test split jsonl (source_image / "
                        "target_image / instruction / speech2text rows)")
    parser.add_argument("--image_dir", required=True,
                        help="root the jsonl's image paths are relative to")
    parser.add_argument("--brain_data", default=None,
                        help="data_final.pkl biosignal dict")
    parser.add_argument("--out", default="parity_out")
    parser.add_argument("--mode", choices=("neural", "neural_speech"),
                        default="neural",
                        help="'neural': deployed replace mode — brain "
                        "embeds replace text (reference inference.py:115, "
                        "the CLIP-I 0.6605 row).  'neural_speech': DUAN-"
                        "fuse brain + speech2text prompts (the CLIP-T "
                        "0.2588 row)")
    # scoring backend (either; see cli/evaluate)
    parser.add_argument("--jax_clip_path", default=None,
                        help="converted eval CLIP bundle (cli/convert "
                        "--eval_clip); this package's towers.  The name is "
                        "the JAX CLI's")
    parser.add_argument("--clip_path", default=None,
                        help="local HF CLIP checkpoint (Hugging Face "
                        "backend)")
    parser.add_argument("--dino_path", default=None)
    parser.add_argument("--jax_dino_path", default=None)
    # generation knobs (passed through to cli/infer)
    parser.add_argument("--lora", action="append", default=None)
    parser.add_argument("--steps", type=int, default=28)
    parser.add_argument("--guidance", type=float, default=3.5)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--target_size", type=int, default=512)
    parser.add_argument("--condition_type", default="subject")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--staged_text", action="store_true",
                        help="12B fuse-mode staging (neural_speech at full "
                        "scale: encode all prompts, free T5/CLIP, then load "
                        "the DiT)")
    parser.add_argument("--components", default=None,
                        help="checkpoint components for the DiT phase "
                        "(e.g. 'flux,vae,encoders,dgf' at 12B)")
    parser.add_argument("--skip_generate", action="store_true",
                        help="re-evaluate an existing outputs dir")
    # parity targets (reference README.md:18)
    parser.add_argument("--target_clip_i", type=float, default=0.6605)
    parser.add_argument("--target_clip_t", type=float, default=0.2588)
    parser.add_argument("--tolerance", type=float, default=0.005)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu', for generation and "
                        "scoring")
    args = parser.parse_args(argv)
    from loongx_tpu_torch.precision import set_precision

    set_precision()

    if not (args.jax_clip_path or args.clip_path):
        parser.error("need a CLIP scoring backend: --jax_clip_path "
                     "(converted bundle, this package's towers) or "
                     "--clip_path (Hugging Face)")

    os.makedirs(args.out, exist_ok=True)
    stage_test_split(args.test_jsonl, args.image_dir, args.out)
    outputs = os.path.join(args.out, "outputs")

    if not args.skip_generate:
        from loongx_tpu_torch.cli import infer as infer_cli

        gen_args = [
            "--checkpoint", args.checkpoint,
            "--input_dir", os.path.join(args.out, "inputs"),
            "--output_dir", outputs,
            "--caption_path", args.test_jsonl,
            "--condition_type", args.condition_type,
            "--target_size", str(args.target_size),
            "--steps", str(args.steps),
            "--guidance", str(args.guidance),
            "--seed", str(args.seed),
            "--device", args.device,
        ]
        if args.brain_data:
            gen_args += ["--brain_data_path", args.brain_data]
        if args.mode == "neural":
            # deployed replace mode: brain embeds replace text embeds
            gen_args += ["--neural_only"]
        else:
            gen_args += ["--fuse"]
            if args.staged_text:
                gen_args += ["--staged_text"]
        if args.batch_size:
            gen_args += ["--batch_size", str(args.batch_size)]
        if args.int8:
            gen_args += ["--int8"]
        if args.components:
            gen_args += ["--components", args.components]
        for entry in args.lora or []:
            gen_args += ["--lora", entry]
        print(f"[parity] generating: infer {' '.join(gen_args)}")
        infer_cli.main(gen_args)

    from loongx_tpu_torch.cli import evaluate as evaluate_cli

    eval_args = [
        "--gen_dir", outputs,
        "--gt_dir", os.path.join(args.out, "gt"),
        "--caption_path", args.test_jsonl,
        "--out_dir", os.path.join(args.out, "eval"),
        "--image_size", str(args.target_size),
        "--device", args.device,
    ]
    for flag in ("jax_clip_path", "clip_path", "dino_path", "jax_dino_path"):
        if getattr(args, flag):
            eval_args += [f"--{flag}", getattr(args, flag)]
    results = evaluate_cli.main(eval_args)

    # compare (reference README.md:18: CLIP-I 0.6605 neural-only,
    # CLIP-T 0.2588 neural+speech; clip_t_gen is the generated-image row,
    # test.py:306-319)
    checks = [("clip_i", args.target_clip_i)]
    if args.mode == "neural_speech":
        checks.append(("clip_t_gen", args.target_clip_t))
    verdict = {}
    ok = True
    for key, target in checks:
        got = results.get(key)
        if got is None:
            print(f"[parity] FAIL: metric {key} was not computed")
            ok = False
            continue
        passed = abs(got - target) <= args.tolerance
        verdict[key] = {"measured": round(got, 4), "target": target,
                        "tolerance": args.tolerance, "pass": passed}
        ok &= passed
    verdict["parity"] = bool(ok)
    with open(os.path.join(args.out, "parity.json"), "w") as f:
        json.dump({"results": {k: round(float(v), 6)
                               for k, v in results.items()},
                   "verdict": verdict}, f, indent=2)
    print(json.dumps(verdict))
    if not ok:
        sys.exit(1)
    return verdict


if __name__ == "__main__":
    main()
