"""Training callbacks (counterpart of ``loongx_tpu/train/callbacks.py``):
an EMA console loss, wandb scalars {loss, gradient_size, t, epoch, steps},
the LoRA file and the train state every ``save_interval`` optimizer steps,
a fixed-seed probe image every ``sample_interval`` steps.  Under a mesh
only the writer (global rank 0) writes files; the others keep the EMA and
run the probe where they are given one.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

# a run's train-state directory under <save_path>/<run name>/
TRAIN_STATE_DIR = "train_state"


class TrainingCallback:
    def __init__(
        self,
        run_name: str,
        save_path: str = "runs",
        save_interval: int = 1000,
        sample_interval: int = 500,
        print_interval: int = 10,
        use_wandb: bool = False,
        wandb_config: Optional[Dict[str, Any]] = None,
        sample_fn: Optional[Callable[[int], Any]] = None,
        frozen: Optional[Dict[str, Any]] = None,
        fingerprint: Optional[Dict[str, Any]] = None,
        writer: bool = True,
    ):
        self.run_name = run_name
        self.frozen = frozen  # complement of state.trainable (for exports)
        self.fingerprint = fingerprint  # resume-compat facts (see checkpoint)
        self.writer = writer  # writes the LoRA files and train states
        self.save_root = os.path.join(save_path, run_name)
        self.save_interval = save_interval
        self.sample_interval = sample_interval
        self.print_interval = print_interval
        self.sample_fn = sample_fn
        self.ema_loss: Optional[float] = None
        self.t_start = time.time()
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(
                    project=(wandb_config or {}).get("project", "loongx-tpu"),
                    name=run_name,
                    config=wandb_config,
                )
                self.wandb = wandb
            except Exception as exc:  # parity: swallowed init failure
                print(f"[callbacks] wandb unavailable: {exc}")

    def on_step_end(
        self, step: int, metrics: Dict[str, Any], state=None, epoch: int = 0
    ):
        loss = float(metrics["loss"])
        # EMA 0.95/0.05 like the reference (model.py:562-566)
        self.ema_loss = (
            loss if self.ema_loss is None else self.ema_loss * 0.95 + loss * 0.05
        )
        if self.wandb is not None:
            self.wandb.log(
                {
                    "loss": loss,
                    "gradient_size": float(metrics.get("grad_norm", np.nan)),
                    "t": float(metrics.get("t_mean", np.nan)),
                    "epoch": epoch,
                    "steps": step,
                }
            )
        if self.print_interval and step % self.print_interval == 0:
            dt = time.time() - self.t_start
            print(
                f"step {step}: loss={loss:.4f} ema={self.ema_loss:.4f} "
                f"gnorm={float(metrics.get('grad_norm', np.nan)):.3f} "
                f"({dt:.0f}s)",
                flush=True,
            )
        if self.save_interval and step > 0 and step % self.save_interval == 0:
            self.save_checkpoint(step, state)
        if (
            self.sample_fn is not None
            and self.sample_interval
            and step > 0
            and step % self.sample_interval == 0
        ):
            try:
                self.sample_fn(step)
            except Exception as exc:
                print(f"[callbacks] sample generation failed: {exc}")

    def save_checkpoint(self, step: int, state):
        """The LoRA file (``ckpt/<step>/lora.safetensors``, with the real
        lora_scale from the frozen tree) and the train state
        (``train_state/step_<step>``); a step already saved is skipped (the
        final save after the loop can fall on an interval's step).  Nothing
        but on the writer."""
        if state is None or not self.writer:
            return
        if getattr(self, "_last_saved_step", None) == step:
            return
        self._last_saved_step = step
        from loongx_tpu_torch.utils.checkpoint import (
            save_lora_safetensors, save_train_checkpoint,
        )

        ckpt_dir = os.path.join(self.save_root, "ckpt", str(step))
        os.makedirs(ckpt_dir, exist_ok=True)
        flux_trainable = state.trainable.get("flux")
        if flux_trainable is not None:
            # the trainable tree holds lora_a / lora_b; lora_scale is a
            # frozen leaf, so the export recombines the two trees
            tree = flux_trainable
            if self.frozen is not None and "flux" in self.frozen:
                from loongx_tpu_torch.train.step import combine

                tree = combine(flux_trainable, self.frozen["flux"])
            try:
                save_lora_safetensors(tree, ckpt_dir)
            except Exception as exc:
                print(f"[callbacks] lora export failed: {exc}")
        save_train_checkpoint(
            os.path.join(self.save_root, TRAIN_STATE_DIR), step,
            state.trainable, state.optimizer, fingerprint=self.fingerprint)
        print(f"[callbacks] saved checkpoint @ step {step} -> {ckpt_dir}")
