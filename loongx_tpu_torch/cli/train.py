"""Training CLI: ``python -m loongx_tpu_torch.cli.train [--config path]``
(counterpart of ``loongx_tpu/cli/train.py``).

Reads the YAML config (``--config``, else ``$XFL_CONFIG``) and runs
`train.loop.train` on one GPU, or on the CPU with ``--device cpu``.
Train states go to ``<save_path>/<run>/train_state/step_<n>`` and LoRA
files to ``<save_path>/<run>/ckpt/<n>/lora.safetensors``; a run resumes
from the newest train state under ``save_path`` unless ``--no_resume``.

Several GPUs: one process a card under ``torchrun``, which the loop's
`parallel.make_mesh` joins (NCCL; ``--device cuda`` is cuda:LOCAL_RANK,
``--device cpu`` takes gloo); the config's ``mesh`` says how many ranks
split the DiT (``tensor``), the rest split the batch:

    torchrun --standalone --nproc-per-node 4 -m loongx_tpu_torch.cli.train \
        --config configs/seed_512.yaml
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="LoongX training (PyTorch)")
    parser.add_argument("--config", type=str, default=None,
                        help="YAML config (default: $XFL_CONFIG)")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--no_resume", action="store_true")
    parser.add_argument("--no_wandb", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    from loongx_tpu_torch.precision import set_precision

    set_precision()

    import torch

    from loongx_tpu_torch.config import load_config
    from loongx_tpu_torch.train.loop import train

    if torch.device(args.device).type == "cuda" and not (
            torch.cuda.is_available()):
        parser.error(f"--device {args.device}: no CUDA device is available "
                     "(pass --device cpu to run on the CPU)")
    config = load_config(args.config)
    summary = train(config, max_steps=args.max_steps,
                    resume=not args.no_resume,
                    use_wandb=False if args.no_wandb else None,
                    device=args.device)
    print(f"[train] done: {summary}")
    return summary


if __name__ == "__main__":
    main()
