"""Driver of the served neural edit: ``loongx_tpu_torch.sampling.generate.
neural_edit`` on the W8A8 int8 FLUX.1-dev serving bundle, one request a
unit, every request new (`perfbench.core.traffic`).

Set-up makes the weights from the seed on the card in the published unfused
layout, runs the program's serving transforms on them (q / k / v fused,
the single blocks' proj_out split) and builds the program's pipeline from
the trees.  The check runs the plain float32 reference
(`perfbench.reference.edit`) over a sample of the window's images, drawn
from the seed, after the program's state is freed, and compares each image
by its relative L2 distance.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from perfbench.core import flops, traffic, weights
from perfbench.reference import edit as ref_edit
from perfbench.reference import layout

STAGES = ("brain_encode", "vae_encode", "denoise", "vae_decode")
# the configuration's "attention_scores" -> neural_edit's int8_attn
SCORES = {"bfloat16": False, "int8": True}


def sizes_of(cfg: Dict[str, Any], mix: Dict[str, Any]) -> Dict[str, int]:
    p = dict(mix["params"])
    ds = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    p.update(tokens=(p["height"] // (2 * ds)) * (p["width"] // (2 * ds)),
             lat_h=p["height"] // ds, lat_w=p["width"] // ds,
             in_channels=cfg["transformer"]["in_channels"],
             latent_channels=cfg["vae"]["latent_channels"])
    return p


def reference_weights(cfg: Dict[str, Any], seed: int, device="cuda"):
    """The unfused trees the program's are made from, made again."""
    return {"flux": weights.make(layout.flux_layout(cfg["transformer"]),
                                 seed, "flux", device),
            "vae": weights.make(layout.vae_layout(cfg["vae"]), seed, "vae",
                                device),
            "brain": weights.make(layout.brain_layout(), seed, "brain",
                                  device)}


def program_configs(cfg: Dict[str, Any]):
    from loongx_tpu_torch.models.flux.model import FluxConfig
    from loongx_tpu_torch.models.flux.vae import VAEConfig

    t, v = cfg["transformer"], cfg["vae"]
    flux_cfg = FluxConfig(
        in_channels=t["in_channels"], num_heads=t["num_attention_heads"],
        head_dim=t["attention_head_dim"], num_double_blocks=t["num_layers"],
        num_single_blocks=t["num_single_layers"],
        joint_dim=t["joint_attention_dim"],
        pooled_dim=t["pooled_projection_dim"],
        guidance_embeds=t["guidance_embeds"],
        axes_dims=tuple(t["axes_dims_rope"]))
    vae_cfg = VAEConfig(
        in_channels=v["in_channels"], latent_channels=v["latent_channels"],
        block_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"],
        norm_groups=v["norm_num_groups"],
        scaling_factor=v["scaling_factor"], shift_factor=v["shift_factor"])
    return flux_cfg, vae_cfg


class Driver:
    unit = "request"
    first_unit = 0

    def __init__(self, cfg: Dict[str, Any], mix: Dict[str, Any], seed: int,
                 device: str = "cuda", dtype=None):
        from loongx_tpu_torch.models.pipeline import LoongXPipeline
        from loongx_tpu_torch.ops.nn import tree_cast
        from loongx_tpu_torch.ops.quant import (
            fuse_qkv_projections, split_single_proj_out,
        )

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.sizes = sizes_of(cfg, mix)
        self.acts = ("int8" if cfg["quantization"]["activations"] == "int8"
                     else "float32")
        # every stated choice reaches the program, or the run is refused
        self.s4_mode = cfg["s4_mode"]
        if cfg["attention_scores"] not in SCORES:
            raise ValueError(f"attention_scores {cfg['attention_scores']!r}: "
                             f"the driver serves {sorted(SCORES)}")
        self.int8_attn = SCORES[cfg["attention_scores"]]
        dtype = getattr(torch, cfg["dtype"]) if dtype is None else dtype
        flux_cfg, vae_cfg = program_configs(cfg)
        w = reference_weights(cfg, seed, device)
        flux = fuse_qkv_projections(w["flux"])
        flux = split_single_proj_out(flux, flux_cfg.hidden)
        params = {"flux": flux, "vae": w["vae"], **w["brain"]}
        if dtype != torch.bfloat16:  # made in bf16: the same values wider
            params = tree_cast(params, dtype)
        self.pipe = LoongXPipeline(flux_cfg, vae_cfg, params, dtype)
        self.outputs: Dict[int, np.ndarray] = {}
        self.spans: Dict[str, float] = {}
        del w, flux, params

    # -- the timed path -----------------------------------------------------

    def warm(self) -> None:
        """One request of the cell's shapes (its own draws)."""
        self.run_unit(-1, keep=False)

    def run_unit(self, i: int, keep: bool = True) -> int:
        """Serve request ``i`` to its end; returns its images."""
        from loongx_tpu_torch.sampling import generate

        p, x = self.mix["params"], traffic.draw(self.mix, self.sizes,
                                                self.seed, i, self.device)
        images = generate.neural_edit(
            self.pipe, x["image"].cpu().numpy(), eeg=x["eeg"], ppg=x["ppg"],
            fnirs=x["fnirs"], motion=x["motion"], height=p["height"],
            width=p["width"], num_inference_steps=p["steps"],
            guidance_scale=p["guidance"], latents=x["latents"],
            cond_noise=x["cond_noise"], s4_mode=self.s4_mode,
            w8a8=self.acts == "int8", int8_attn=self.int8_attn)
        if keep:
            self.outputs[i] = images
        return images.shape[0]

    @contextlib.contextmanager
    def stage_spans(self):
        """Host-clock spans of the edit's stages (each ends in a
        synchronize) around the program's module functions, while the block
        runs."""
        from loongx_tpu_torch.sampling import generate

        saved = {name: getattr(generate, name) for name in STAGES}

        def timed(name, fn):
            def wrapper(*a, **k):
                sync()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                sync()
                self.spans[name] = (self.spans.get(name, 0.0)
                                    + time.perf_counter() - t0)
                return out
            return wrapper

        sync = (torch.cuda.synchronize if self.device == "cuda"
                else lambda: None)
        try:
            for name, fn in saved.items():
                setattr(generate, name, timed(name, fn))
            yield self.spans
        finally:
            for name, fn in saved.items():
                setattr(generate, name, fn)

    # -- the yardstick --------------------------------------------------------

    def steps_per_unit(self) -> int:
        return self.mix["params"]["steps"]

    def ops_per_unit(self) -> List[flops.Op]:
        s = self.sizes
        return self.steps_per_unit() * flops.serve_forward(
            self.cfg["transformer"], s["batch"], s["text_tokens"],
            s["tokens"], s["tokens"])

    # -- the check ------------------------------------------------------------

    def sample(self, done: List[int]) -> List[Tuple[int, int]]:
        """(request, image) pairs to compare, drawn from the seed: the
        mix's ``check.images`` of them, one from each half of the batch
        first where the batch has two halves."""
        rng = np.random.default_rng(weights.derive_seed(self.seed, "check"))
        b, n = self.mix["params"]["batch"], self.mix["check"]["images"]
        halves = [range(0, max(1, b // 2)), range(b // 2, b)] if b > 1 \
            else [range(1)]
        picks = []
        for k in range(n):
            unit = int(done[rng.integers(len(done))])
            half = halves[k % len(halves)]
            picks.append((unit, int(half[rng.integers(len(half))])))
        return picks

    def free(self) -> None:
        self.pipe = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self, done: List[int], control: bool = False
              ) -> Dict[str, Tuple[float, float]]:
        """{number: (reading, limit)}: the widest relative L2 distance of a
        sampled image from the reference's.  ``control`` also reads the
        control (the reference with 4-bit activations in the program's
        place) on the same images, into ``self.control``."""
        picks = self.sample(done)
        self.free()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref_w = reference_weights(self.cfg, self.seed, self.device)
        p, worst, self.control = self.mix["params"], 0.0, {}
        with torch.no_grad():
            for unit, j in picks:
                x = traffic.draw(self.mix, self.sizes, self.seed, unit,
                                 self.device)
                x = {k: v[j:j + 1] for k, v in x.items()}

                def edit(acts):
                    return ref_edit.neural_edit(ref_w, self.cfg, x, p["steps"],
                                                p["guidance"], acts)

                ref = edit(self.acts)
                got = torch.as_tensor(self.outputs[unit][j:j + 1],
                                      device=ref.device)
                worst = max(worst, rel_l2(got, ref))
                if control:
                    self.control["image_rel_l2"] = max(
                        self.control.get("image_rel_l2", 0.0),
                        rel_l2(edit("int4"), ref))
        limit = self.cfg["checks"]["image_rel_l2"]
        return {"image_rel_l2": (worst, limit)}


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref).norm() / ref.norm())
