"""Periodic sample generation during training, a visual regression probe
(counterpart of ``loongx_tpu/train/sampling_probe.py``): every
``sample_interval`` optimizer steps, `generate()` renders a fixed probe
(fixed seed, fixed condition image, the training wiring ``fuse_mode=
"train"``) with the current LoRA weights, saved as a JPEG by Pillow.
Where the text encoders were freed (staged text) the probe takes its
prompt's cached embeds; the JAX package's probe calls the freed T5 there
and fails at every interval.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


class SampleProbe:
    """Callable for `TrainingCallback`'s ``sample_fn``."""

    def __init__(
        self,
        pipeline,
        condition_type: str = "subject",
        probe_image: Optional[np.ndarray] = None,  # [H, W, 3] float [0, 1]
        prompt: str = "",
        biosignals: Optional[Dict[str, np.ndarray]] = None,
        out_dir: str = "runs/samples",
        seed: int = 42,
        num_steps: int = 8,
        size: int = 512,
        trainable_view=None,
        text_cache=None,
        write: bool = True,
    ):
        self.pipeline = pipeline
        self.condition_type = condition_type
        self.probe_image = probe_image
        self.prompt = prompt
        self.biosignals = biosignals or {}
        self.out_dir = out_dir
        self.seed = seed
        self.num_steps = num_steps
        self.size = size
        # a callable returning the current trainable tree, so that probes
        # render with the LoRA weights as they are now
        self.trainable_view = trainable_view
        # staged text (`train.prepare.build_text_cache`): the prompt's
        # embeds where the text encoders are no longer loaded
        self.text_cache = text_cache
        # under a tensor axis every rank of the data row renders (generate()
        # needs their collectives) and one writes the image
        self.write = write

    @torch.no_grad()
    def __call__(self, step: int) -> Optional[str]:
        from PIL import Image

        from loongx_tpu_torch.sampling.condition import Condition
        from loongx_tpu_torch.sampling.generate import generate
        from loongx_tpu_torch.train.step import combine

        pipeline = self.pipeline
        if self.trainable_view is not None:
            # either the whole pipeline partition (the training loop's) or
            # a bare flux tree
            trainable = self.trainable_view()
            if "flux" in trainable:
                merged = combine(trainable, pipeline.params)
            else:
                merged = {"flux": combine(trainable, pipeline.params["flux"])}
            pipeline = dataclasses.replace(
                pipeline, params={**pipeline.params, **merged})

        conditions = None
        if self.probe_image is not None:
            img = (self.probe_image * 255).astype(np.uint8)
            conditions = [Condition(self.condition_type, condition=img)]
        use_brain = bool(self.biosignals)
        text = self._text(pipeline, use_brain)
        out = generate(
            pipeline,
            **text,
            conditions=conditions,
            height=self.size,
            width=self.size,
            num_inference_steps=self.num_steps,
            seed=self.seed,
            eeg=self.biosignals.get("EEG"),
            fnirs=self.biosignals.get("FNIRS"),
            ppg=self.biosignals.get("PPG"),
            motion=self.biosignals.get("Motion"),
            use_brain_condition=use_brain,
            fuse_flag=True,
            # the training wiring: the probe renders what the step
            # optimizes, and it takes samples without fNIRS
            fuse_mode="train",
            output_type="uint8",
        )
        if not self.write:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"step_{step}.jpg")
        Image.fromarray(out[0]).save(path)
        print(f"[probe] saved {path}")
        return path

    def _text(self, pipeline, use_brain: bool) -> Dict[str, Any]:
        """The prompt when the pipeline can encode it (tokenizers and text
        encoders loaded), else its staged embeds, else zero embeds.  A
        tokenizer alone does not do: a staged run's pipeline keeps the
        tokenizers of its directory but not the encoders."""
        if pipeline.t5_tokenizer is not None and "t5" in pipeline.params:
            return {"prompt": self.prompt}
        cache = self.text_cache[0] if self.text_cache is not None else {}
        if self.prompt in cache:
            embeds, pooled = cache[self.prompt]
            return {"prompt_embeds": embeds[None].to(pipeline.device),
                    "pooled_prompt_embeds": pooled[None].to(pipeline.device)}
        return {"prompt_embeds": _zero_embeds(pipeline, use_brain),
                "pooled_prompt_embeds": _zero_pooled(pipeline)}


def _zero_embeds(pipeline, fuse: bool = False) -> torch.Tensor:
    """Zero prompt embeds: as many tokens as the DGF's fixed channel count
    (512) where brain embeds are fused into them, else 8."""
    dgf = pipeline.params.get("dgf")
    s = (dgf["duan_prompt"]["gate_in"]["kernel"].shape[0]
         if fuse and dgf is not None else 8)
    return torch.zeros(1, s, pipeline.flux_cfg.joint_dim, dtype=pipeline.dtype,
                       device=pipeline.device)


def _zero_pooled(pipeline) -> torch.Tensor:
    return torch.zeros(1, pipeline.flux_cfg.pooled_dim, dtype=pipeline.dtype,
                       device=pipeline.device)
