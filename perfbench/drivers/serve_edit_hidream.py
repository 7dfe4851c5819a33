"""Driver of the served neural edit on HiDream-I1: ``loongx_tpu_torch.
sampling.generate.neural_edit`` on a W8A8 int8 HiDream-I1 serving bundle
(a `LoongXPipeline` holding a ``HiDreamConfig``), one request a unit, every
request new (`perfbench.core.traffic`).

Set-up makes the weights from the seed on the card in the published
unfused layout (`perfbench.reference.hidream.make_weights`), runs the
program's serving transforms on them (``models.hidream.model.
serving_layout``: q / k / v fused, each SwiGLU's W1 and W3 fused and
interleaved) and builds the program's pipeline.  The brain prompt takes
the T5 slot, the brain pooled vector the CLIP-L part of the pooled input;
the Llama streams and the CLIP-G pooled part are drawn with the request.
The check runs the plain float32 reference (`perfbench.reference.hidream`)
over a sample of the window's images after the program's state is freed
and compares each image by its relative L2 distance, as `serve_edit` does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from perfbench.core import flops_hidream, traffic, weights
from perfbench.drivers import serve_edit
from perfbench.drivers.serve_edit import SCORES, rel_l2
from perfbench.reference import hidream as ref
from perfbench.reference import layout


def sizes_of(cfg: Dict[str, Any], mix: Dict[str, Any]) -> Dict[str, int]:
    p = dict(mix["params"])
    t = cfg["transformer"]
    ds = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    patch = t["patch_size"]
    p.update(tokens=(p["height"] // (patch * ds)) * (p["width"] // (patch * ds)),
             lat_h=p["height"] // ds, lat_w=p["width"] // ds,
             in_channels=patch ** 2 * t["in_channels"],
             latent_channels=cfg["vae"]["latent_channels"])
    return p


def reference_weights(cfg: Dict[str, Any], seed: int, device="cuda"):
    """The unfused trees the program's are made from, made again."""
    return {"hidream": ref.make_weights(cfg["transformer"], seed, device),
            "vae": weights.make(layout.vae_layout(cfg["vae"]), seed, "vae",
                                device),
            "brain": weights.make(layout.brain_layout(), seed, "brain",
                                  device)}


def program_configs(cfg: Dict[str, Any]):
    from loongx_tpu_torch.models.flux.vae import VAEConfig
    from loongx_tpu_torch.models.hidream.model import HiDreamConfig

    t, v = cfg["transformer"], cfg["vae"]
    dit = HiDreamConfig(
        patch_size=t["patch_size"], latent_channels=t["in_channels"],
        num_heads=t["num_attention_heads"], head_dim=t["attention_head_dim"],
        num_double_blocks=t["num_layers"],
        num_single_blocks=t["num_single_layers"],
        caption_dim=t["caption_channels"][0], pooled_dim=t["text_emb_dim"],
        num_experts=t["num_routed_experts"],
        top_k=t["num_activated_experts"], axes_dims=tuple(t["axes_dims_rope"]),
        ffn_multiple_of=t.get("ffn_multiple_of", 256))
    vae_cfg = VAEConfig(
        in_channels=v["in_channels"], latent_channels=v["latent_channels"],
        block_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"],
        norm_groups=v["norm_num_groups"],
        scaling_factor=v["scaling_factor"], shift_factor=v["shift_factor"])
    return dit, vae_cfg


class Driver(serve_edit.Driver):
    """`serve_edit.Driver`'s timed path, stage spans, sample and check on the
    HiDream bundle."""

    def __init__(self, cfg: Dict[str, Any], mix: Dict[str, Any], seed: int,
                 device: str = "cuda", dtype=None):
        from loongx_tpu_torch.models.hidream.model import serving_layout
        from loongx_tpu_torch.models.pipeline import LoongXPipeline
        from loongx_tpu_torch.ops.nn import tree_cast

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.sizes = sizes_of(cfg, mix)
        self.acts = ("int8" if cfg["quantization"]["activations"] == "int8"
                     else "float32")
        self.s4_mode = cfg["s4_mode"]
        if cfg["attention_scores"] not in SCORES:
            raise ValueError(f"attention_scores {cfg['attention_scores']!r}: "
                             f"the driver serves {sorted(SCORES)}")
        self.int8_attn = SCORES[cfg["attention_scores"]]
        dtype = getattr(torch, cfg["dtype"]) if dtype is None else dtype
        dit_cfg, vae_cfg = program_configs(cfg)
        w = reference_weights(cfg, seed, device)
        dit = serving_layout(w.pop("hidream"))
        params = {"flux": dit, "vae": w["vae"], **w["brain"]}
        if dtype != torch.bfloat16:  # made in bf16: the same values wider
            params = tree_cast(params, dtype)
        self.pipe = LoongXPipeline(dit_cfg, vae_cfg, params, dtype)
        self.outputs: Dict[int, np.ndarray] = {}
        self.spans: Dict[str, float] = {}
        del w, dit, params

    def run_unit(self, i: int, keep: bool = True) -> int:
        """Serve request ``i`` to its end; returns its images."""
        from loongx_tpu_torch.sampling import generate

        p, x = self.mix["params"], traffic.draw(self.mix, self.sizes,
                                                self.seed, i, self.device)
        images = generate.neural_edit(
            self.pipe, x["image"].cpu().numpy(), eeg=x["eeg"], ppg=x["ppg"],
            fnirs=x["fnirs"], motion=x["motion"], height=p["height"],
            width=p["width"], num_inference_steps=p["steps"],
            latents=x["latents"], cond_noise=x["cond_noise"],
            s4_mode=self.s4_mode, w8a8=self.acts == "int8",
            int8_attn=self.int8_attn, text_streams=x["llama"],
            pooled_extra=x["pooled_extra"])
        if keep:
            self.outputs[i] = images
        return images.shape[0]

    def ops_per_unit(self) -> List[flops_hidream.Op]:
        s, t = self.sizes, self.cfg["transformer"]
        llama = s["llama_tokens"]
        return (self.steps_per_unit() * flops_hidream.serve_forward(
            t, s["batch"], s["text_tokens"] + llama, llama, s["tokens"],
            s["tokens"])
            + flops_hidream.caption_ops(t, s["batch"], s["text_tokens"],
                                        llama))

    def reference_edit(self, ref_w, x, acts: str, routings=None):
        return ref.neural_edit(ref_w, self.cfg, x, self.mix["params"]["steps"],
                               acts, routings)

    def check(self, done: List[int], control: bool = False
              ) -> Dict[str, Tuple[float, float]]:
        """{number: (reading, limit)}: the widest relative L2 distance of a
        sampled image from the reference's; ``control`` also reads the
        reference with 4-bit activations on the same images."""
        picks = self.sample(done)
        self.free()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref_w = reference_weights(self.cfg, self.seed, self.device)
        worst, self.control = 0.0, {}
        with torch.no_grad():
            for unit, j in picks:
                x = traffic.draw(self.mix, self.sizes, self.seed, unit,
                                 self.device)
                x = {k: v[j:j + 1] for k, v in x.items()}
                want = self.reference_edit(ref_w, x, self.acts)
                got = torch.as_tensor(self.outputs[unit][j:j + 1],
                                      device=want.device)
                worst = max(worst, rel_l2(got, want))
                if control:
                    self.control["image_rel_l2"] = max(
                        self.control.get("image_rel_l2", 0.0),
                        rel_l2(self.reference_edit(ref_w, x, "int4"), want))
        limit = self.cfg["checks"]["image_rel_l2"]
        return {"image_rel_l2": (worst, limit)}
