"""The model bundle (counterpart of ``loongx_tpu/models/pipeline.py``):
configs plus the param trees on one device -- {"flux", "vae", "encoders",
"dgf"} to serve the neural edit, with "t5" and "clip" added
(`add_text_encoders`) to serve text prompts, {"flux", "encoders", "dgf"} to
train.

Tokenizers are any callables with the Hugging Face interface the JAX package
uses: ``tok(prompts, padding="max_length", max_length=n, truncation=True,
return_tensors="np").input_ids`` -> int array [B, n]."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from loongx_tpu_torch.models.encoders import (
    init_eeg_encoder, init_fnirs_encoder, init_motion_encoder, init_ppg_encoder,
)
from loongx_tpu_torch.models.flux.model import FluxConfig, init_flux_params
from loongx_tpu_torch.models.flux.vae import (
    VAEConfig, init_vae_params, scale_latents, vae_encode, vae_sample,
)
from loongx_tpu_torch.models.hidream.model import (
    HiDreamConfig, init_hidream_params, serving_layout,
)
from loongx_tpu_torch.models.fusion import init_dgf
from loongx_tpu_torch.models.text.clip import (
    CLIPTextConfig, clip_encode, init_clip_params,
)
from loongx_tpu_torch.models.text.t5 import T5Config, init_t5_params, t5_encode
from loongx_tpu_torch.ops.latents import pack_latents
from loongx_tpu_torch.ops.quant import (
    fuse_qkv_projections, quantize_tree, random_quantized_like,
    split_single_proj_out,
)
from loongx_tpu_torch.train.lora import add_lora


@dataclasses.dataclass
class LoongXPipeline:
    # the DiT's config: FLUX.1 (every mode) or HiDream-I1 (served by
    # `sampling.generate.neural_edit`, W8A8); its tree is params["flux"]
    flux_cfg: Union[FluxConfig, HiDreamConfig]
    vae_cfg: Optional[VAEConfig]
    params: Dict[str, Any]
    dtype: torch.dtype = torch.bfloat16
    # named LoRA adapters (train.adapters.AdapterRegistry, or any registry
    # with its interface: ``in``, ``activate``, ``deactivate``, ``names``)
    adapters: Optional[Any] = None
    active_adapter: Optional[str] = None
    t5_cfg: Optional[T5Config] = None
    clip_cfg: Optional[CLIPTextConfig] = None
    t5_tokenizer: Any = None
    clip_tokenizer: Any = None
    max_sequence_length: int = 512

    def set_adapters(self, name: str) -> bool:
        """Activate the named LoRA adapter on the DiT.  No-op (False) with
        no registry; KeyError on an unknown name."""
        if self.adapters is None:
            return False
        if name != self.active_adapter:
            self.params["flux"] = self.adapters.activate(self.params["flux"],
                                                         name)
            self.active_adapter = name
        return True

    @property
    def device(self) -> torch.device:
        """The device of the params (the first leaf found: a bundle loaded
        with some components only may have no DiT)."""
        node = self.params
        while not isinstance(node, torch.Tensor):
            node = next(iter(node.values() if isinstance(node, dict)
                             else node))
        return node.device

    @staticmethod
    def init_serving(flux_cfg: Optional[FluxConfig] = None,
                     vae_cfg: Optional[VAEConfig] = None, *, seed: int = 0,
                     device="cuda", tp_layout: bool = False
                     ) -> "LoongXPipeline":
        """The serving bundle with random weights made on ``device`` from
        ``seed``: random int8 DiT (every linear quantized, qkv fused, the
        single-block proj_out split), bf16 VAE, CS3 encoders and DGF.
        ``tp_layout``: the tensor-parallel serving bundle of the same
        weights (qkv fused in the TP layout, proj_out whole; see
        `quantize`).  A `HiDreamConfig` gives the HiDream-I1 bundle in its
        serving layout (`models.hidream.model.serving_layout`; its router
        drawn N(0, 1) / sqrt(D)); it has no tensor-parallel layout."""
        flux_cfg = flux_cfg or FluxConfig.flux_dev()
        vae_cfg = vae_cfg or VAEConfig.flux()
        gen = torch.Generator(device=device).manual_seed(seed)
        if isinstance(flux_cfg, HiDreamConfig):
            if tp_layout:
                raise NotImplementedError("no tensor-parallel HiDream layout")
            shapes = init_hidream_params(flux_cfg, dtype=torch.bfloat16,
                                         device="meta")
            dit = random_quantized_like(shapes, generator=gen, device=device)
            for name in ("double_blocks", "single_blocks"):
                gate = dit[name]["moe"]["gate"]
                gate["weight"] = torch.randn(
                    gate["weight"].shape, generator=gen, device=device
                ) / flux_cfg.hidden ** 0.5
            kw = dict(generator=gen, dtype=torch.bfloat16, device=device)
            params = {"flux": serving_layout(dit),
                      "vae": init_vae_params(vae_cfg, **kw), **_brain_params(kw)}
            return LoongXPipeline(flux_cfg, vae_cfg, params, torch.bfloat16)
        flux = random_quantized_like(
            init_flux_params(flux_cfg, dtype=torch.bfloat16, device="meta"),
            generator=gen, device=device)
        flux = fuse_qkv_projections(flux, tp_layout=tp_layout)
        if not tp_layout:
            flux = split_single_proj_out(flux, flux_cfg.hidden)
        kw = dict(generator=gen, dtype=torch.bfloat16, device=device)
        params = {"flux": flux, "vae": init_vae_params(vae_cfg, **kw),
                  **_brain_params(kw)}
        return LoongXPipeline(flux_cfg, vae_cfg, params, torch.bfloat16)

    @staticmethod
    def init_training(flux_cfg: Optional[FluxConfig] = None, *, seed: int = 0,
                      device="cuda") -> "LoongXPipeline":
        """The QLoRA training bundle of ``configs/seed_512.yaml`` with random
        weights made on ``device`` from ``seed``: random int8 DiT in the
        training layout (q/k/v unfused, proj_out whole), bf16 LoRA leaves
        (r 4, alpha 4) on ``DEFAULT_TARGETS``, CS3 encoders and DGF.  No
        VAE: the step takes packed latents."""
        flux_cfg = flux_cfg or FluxConfig.flux_dev()
        gen = torch.Generator(device=device).manual_seed(seed)
        flux = random_quantized_like(
            init_flux_params(flux_cfg, dtype=torch.bfloat16, device="meta"),
            generator=gen, device=device)
        flux = add_lora(flux, r=4, alpha=4, dtype=torch.bfloat16, generator=gen)
        kw = dict(generator=gen, dtype=torch.bfloat16, device=device)
        return LoongXPipeline(flux_cfg, None, {"flux": flux, **_brain_params(kw)},
                              torch.bfloat16)

    @staticmethod
    def init_random(generator: Optional[torch.Generator] = None,
                    flux_cfg: Optional[FluxConfig] = None,
                    vae_cfg: Optional[VAEConfig] = None,
                    t5_cfg: Optional[T5Config] = None,
                    clip_cfg: Optional[CLIPTextConfig] = None,
                    dtype=torch.bfloat16, with_biosignal: bool = True,
                    device="cuda") -> "LoongXPipeline":
        """Random float weights made on ``device`` from ``generator``: the
        DiT (FLUX.1-dev by default), VAE, T5 (XXL), CLIP text (L) and, with
        ``with_biosignal``, the CS3 encoders and DGF; the JAX package's
        trees."""
        flux_cfg = flux_cfg or FluxConfig.flux_dev()
        vae_cfg = vae_cfg or VAEConfig.flux()
        t5_cfg = t5_cfg or T5Config.xxl()
        clip_cfg = clip_cfg or CLIPTextConfig.large()
        kw = dict(generator=generator, dtype=dtype, device=device)
        params: Dict[str, Any] = {
            "flux": init_flux_params(flux_cfg, **kw),
            "vae": init_vae_params(vae_cfg, **kw),
            "t5": init_t5_params(t5_cfg, **kw),
            "clip": init_clip_params(clip_cfg, **kw),
        }
        if with_biosignal:
            params.update(_brain_params(kw))
        return LoongXPipeline(flux_cfg, vae_cfg, params, dtype,
                              t5_cfg=t5_cfg, clip_cfg=clip_cfg)

    @staticmethod
    def tiny(generator: Optional[torch.Generator] = None,
             dtype=torch.float32, with_biosignal: bool = False,
             device="cuda") -> "LoongXPipeline":
        """Miniature pipeline for tests, the JAX package's `tiny`: tiny VAE,
        T5, CLIP and a 2 + 2 block DiT whose widths fit them.  The CS3
        encoders and DGF (``with_biosignal``) keep their full size: their
        widths are fixed by the reference contract."""
        vae_cfg, t5_cfg = VAEConfig.tiny(), T5Config.tiny()
        clip_cfg = CLIPTextConfig.tiny()
        flux_cfg = FluxConfig(
            in_channels=4 * vae_cfg.latent_channels, num_heads=2, head_dim=32,
            num_double_blocks=2, num_single_blocks=2,
            joint_dim=t5_cfg.d_model, pooled_dim=clip_cfg.hidden,
            axes_dims=(8, 12, 12))
        return LoongXPipeline.init_random(
            generator, flux_cfg, vae_cfg, t5_cfg, clip_cfg, dtype,
            with_biosignal=with_biosignal, device=device)

    @staticmethod
    def from_pretrained(path: str, dtype=torch.bfloat16,
                        quantize: bool = False, components=None,
                        device="cuda") -> "LoongXPipeline":
        """Load a pipeline directory written by `utils.checkpoint.
        save_pipeline` (``cli/convert.py``) onto ``device``; ``components``
        names the param files to read (None: all).  ``quantize=True``
        int8-quantizes the DiT and text encoders after the load (convert
        with ``--quantize`` where the float tree does not fit the card)."""
        from loongx_tpu_torch.utils.checkpoint import load_pipeline

        pipe = load_pipeline(path, dtype=dtype, components=components,
                             device=device)
        return pipe.quantize() if quantize else pipe

    def add_text_encoders(self, t5_cfg: Optional[T5Config] = None,
                          clip_cfg: Optional[CLIPTextConfig] = None, *,
                          seed: int = 0, t5_tokenizer: Any = None,
                          clip_tokenizer: Any = None) -> "LoongXPipeline":
        """Complete a serving bundle for text prompts: random T5 (XXL by
        default) and CLIP text (L) encoders made on the pipeline's device
        from ``seed`` with the JAX package's init, then int8-quantized
        (`quantize(dit=False)`), as the JAX package serves them.  Returns
        self."""
        device = self.device
        gen = torch.Generator(device=device).manual_seed(seed)
        self.t5_cfg = t5_cfg or T5Config.xxl()
        self.clip_cfg = clip_cfg or CLIPTextConfig.large()
        kw = dict(generator=gen, dtype=self.dtype, device=device)
        self.params["t5"] = init_t5_params(self.t5_cfg, **kw)
        self.params["clip"] = init_clip_params(self.clip_cfg, **kw)
        self.t5_tokenizer, self.clip_tokenizer = t5_tokenizer, clip_tokenizer
        return self.quantize(dit=False, text=True)

    def quantize(self, dit: bool = True, text: bool = True,
                 fuse_qkv: bool = True, split_proj_out: bool = True,
                 tp_layout: bool = False) -> "LoongXPipeline":
        """Int8-quantize weights in place (per output channel,
        `ops.quant.quantize_tree`): the DiT (then, unless switched off, its
        qkv fused and the single-block proj_out split, the serving layout)
        and the text encoders.  ``tp_layout`` gives the tensor-parallel
        serving bundle, as the JAX package's CLI builds it: qkv fused in
        the TP layout (`fuse_qkv_projections(tp_layout=True)`; none where
        ``fuse_qkv`` is off) and proj_out whole.  Returns self."""
        if dit and "flux" in self.params:
            flux = quantize_tree(self.params["flux"])
            if fuse_qkv:
                flux = fuse_qkv_projections(flux, tp_layout=tp_layout)
            if split_proj_out and not tp_layout:
                flux = split_single_proj_out(flux, self.flux_cfg.hidden)
            self.params["flux"] = flux
        if text:
            for name in ("t5", "clip"):
                if name in self.params:
                    self.params[name] = quantize_tree(self.params[name])
        return self

    def free_text_encoders(self) -> None:
        """Drop the T5 and CLIP params and the tokenizers (their device
        memory returns to PyTorch's allocator); `encode_text` then needs
        ``neural_only``."""
        for name in ("t5", "clip"):
            self.params.pop(name, None)
        self.t5_tokenizer = None
        self.clip_tokenizer = None

    def encode_image_tokens(self, images: torch.Tensor,
                            noise: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, int, int]:
        """images [B, H, W, 3] in [-1, 1] -> (packed latent tokens, lat_h,
        lat_w).  ``noise`` (standard normals of the latent's shape) samples
        the latent distribution; without it the mean is used."""
        mean, logvar = vae_encode(self.params["vae"], self.vae_cfg,
                                  images.to(self.dtype))
        lat = vae_sample(mean, logvar, noise) if noise is not None else mean
        lat = scale_latents(self.vae_cfg, lat)
        return pack_latents(lat), lat.shape[1], lat.shape[2]

    def encode_text(self, prompts, neural_only: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """prompts (str | list[str] | None) -> (prompt_embeds [B, S, 4096],
        pooled [B, 768], txt_ids [S, 3]).  Without tokenizers this is a hard
        error unless ``neural_only``: then the embeds are zeros, safe only
        where brain embeds replace them (fuse_flag=False)."""
        if prompts is None:
            prompts = [""]
        elif isinstance(prompts, str):
            prompts = [prompts]
        device = self.device
        if self.t5_tokenizer is None or self.clip_tokenizer is None:
            if not neural_only:
                raise RuntimeError(
                    "encode_text: no tokenizers loaded in this pipeline. "
                    "Add t5_tokenizer/clip_tokenizer directories to the "
                    "checkpoint for text conditioning, or pass "
                    "neural_only=True (CLI: --neural_only) if brain "
                    "embeddings replace text embeddings (fuse_flag=False).")
            b, s = len(prompts), self.max_sequence_length
            return (torch.zeros(b, s, self.flux_cfg.joint_dim, dtype=self.dtype,
                                device=device),
                    torch.zeros(b, self.flux_cfg.pooled_dim, dtype=self.dtype,
                                device=device),
                    torch.zeros(s, 3, dtype=torch.float32, device=device))
        t5_ids = self.t5_tokenizer(
            prompts, padding="max_length", max_length=self.max_sequence_length,
            truncation=True, return_tensors="np").input_ids
        prompt_embeds = t5_encode(self.params["t5"], self.t5_cfg,
                                  torch.as_tensor(t5_ids, device=device))
        clip_ids = self.clip_tokenizer(
            prompts, padding="max_length",
            max_length=min(77, self.clip_cfg.max_positions), truncation=True,
            return_tensors="np").input_ids
        _, pooled = clip_encode(self.params["clip"], self.clip_cfg,
                                torch.as_tensor(clip_ids, device=device))
        txt_ids = torch.zeros(prompt_embeds.shape[1], 3, dtype=torch.float32,
                              device=device)
        return prompt_embeds.to(self.dtype), pooled.to(self.dtype), txt_ids


def _brain_params(kw) -> Dict[str, Any]:
    """Random CS3 encoders and DGF."""
    return {
        "encoders": {
            "eeg": init_eeg_encoder(**kw),
            "ppg": init_ppg_encoder(**kw),
            "fnirs": init_fnirs_encoder(**kw),
            "motion": init_motion_encoder(**kw),
        },
        "dgf": init_dgf(**kw),
    }
