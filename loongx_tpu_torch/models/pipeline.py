"""The model bundles (counterpart of the parts of
``loongx_tpu/models/pipeline.py`` the neural edit and the QLoRA step use):
configs plus the param trees on one device -- {"flux", "vae", "encoders",
"dgf"} to serve from, {"flux", "encoders", "dgf"} to train."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from loongx_tpu_torch.models.encoders import (
    init_eeg_encoder, init_fnirs_encoder, init_motion_encoder, init_ppg_encoder,
)
from loongx_tpu_torch.models.flux.model import FluxConfig, init_flux_params
from loongx_tpu_torch.models.flux.vae import VAEConfig, init_vae_params
from loongx_tpu_torch.models.fusion import init_dgf
from loongx_tpu_torch.ops.quant import (
    fuse_qkv_projections, random_quantized_like, split_single_proj_out,
)
from loongx_tpu_torch.train.lora import add_lora


@dataclasses.dataclass
class LoongXPipeline:
    flux_cfg: FluxConfig
    vae_cfg: Optional[VAEConfig]
    params: Dict[str, Any]
    dtype: torch.dtype = torch.bfloat16
    # named LoRA adapters: any registry with the JAX package's
    # AdapterRegistry interface (``in``, ``activate``, ``deactivate``,
    # ``names``) over this package's param trees
    adapters: Optional[Any] = None
    active_adapter: Optional[str] = None

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
        return self.params["flux"]["x_embedder"]["bias"].device

    @staticmethod
    def init_serving(flux_cfg: Optional[FluxConfig] = None,
                     vae_cfg: Optional[VAEConfig] = None, *, seed: int = 0,
                     device="cuda") -> "LoongXPipeline":
        """The serving bundle with random weights made on ``device`` from
        ``seed``: random int8 DiT (every linear quantized, qkv fused, the
        single-block proj_out split), bf16 VAE, CS3 encoders and DGF."""
        flux_cfg = flux_cfg or FluxConfig.flux_dev()
        vae_cfg = vae_cfg or VAEConfig.flux()
        gen = torch.Generator(device=device).manual_seed(seed)
        flux = random_quantized_like(
            init_flux_params(flux_cfg, dtype=torch.bfloat16, device="meta"),
            generator=gen, device=device)
        flux = split_single_proj_out(fuse_qkv_projections(flux),
                                     flux_cfg.hidden)
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
