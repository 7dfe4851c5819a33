"""The deployed neural edit: CS3 + DGF brain encode (replace mode) ->
condition-image VAE encode -> flow-match Euler denoise over the DiT -> VAE
decode (counterpart of ``loongx_tpu/sampling/generate.py``: `denoise_scan`,
`_brain_encode_jit`, `fused_edit_program`, `neural_edit`).

PyTorch runs eagerly, so the denoise loop is a Python loop over the sigma
pairs and "fused" only means one function.  Random draws (latents, the VAE
sample noise) are explicit inputs or come from a ``torch.Generator``: the
JAX package's ``jax.random`` streams cannot be reproduced here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from loongx_tpu_torch.models.encoders import (
    eeg_encode, fnirs_encode, motion_encode, ppg_encode,
)
from loongx_tpu_torch.models.flux.model import FluxConfig, flux_forward
from loongx_tpu_torch.models.flux.vae import (
    scale_latents, unscale_latents, vae_decode, vae_encode, vae_sample,
)
from loongx_tpu_torch.models.fusion import fuse_eeg_ppg, fuse_fnirs_motion
from loongx_tpu_torch.ops.latents import (
    latent_image_ids, pack_latents, shift_ids, unpack_latents,
)
from loongx_tpu_torch.ops.schedule import euler_step, flux_sigmas


def denoise(flux_params, flux_cfg: FluxConfig, flags: Dict[str, Any],
            latents: torch.Tensor, txt: torch.Tensor, pooled: torch.Tensor,
            img_ids: torch.Tensor, txt_ids: torch.Tensor,
            cond: Optional[torch.Tensor], cond_ids: Optional[torch.Tensor],
            sigmas: np.ndarray, guidance: Optional[torch.Tensor],
            c_factor: Optional[float], w8a8: bool = False) -> torch.Tensor:
    """The denoise loop; sigmas [steps + 1] float32 (host), the DiT's
    timestep is sigma itself."""
    lat = latents
    for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
        t = torch.full((lat.shape[0],), float(sigma), dtype=torch.float32,
                       device=lat.device)
        v = flux_forward(
            flux_params, flux_cfg, img=lat.to(txt.dtype), txt=txt,
            pooled=pooled, timestep=t, guidance=guidance, img_ids=img_ids,
            txt_ids=txt_ids, cond=cond, cond_ids=cond_ids, flags=flags,
            c_factor=c_factor, w8a8=w8a8)
        lat = euler_step(lat, v, sigma, sigma_next)
    return lat


def brain_encode(enc, dgf, eeg, ppg, fnirs, motion, s4_mode: str = "conv"
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Biosignals -> (brain prompt [B, 512, 4096] | None, brain pooled
    [B, 768] | None): eeg(+ppg) fill the prompt slot, fnirs(+motion) the
    pooled slot."""
    brain_prompt = None
    if eeg is not None:
        eeg_feat = eeg_encode(enc["eeg"], eeg, s4_mode)
        if ppg is not None:
            brain_prompt = fuse_eeg_ppg(dgf, eeg_feat,
                                        ppg_encode(enc["ppg"], ppg, s4_mode))
        else:
            brain_prompt = eeg_feat
    brain_pooled = None
    if fnirs is not None:
        fnirs_feat = fnirs_encode(enc["fnirs"], fnirs, s4_mode)
        if motion is not None:
            brain_pooled = fuse_fnirs_motion(
                dgf, fnirs_feat, motion_encode(enc["motion"], motion, s4_mode))
        else:
            brain_pooled = fnirs_feat
    return brain_prompt, brain_pooled


def fused_edit_program(flux_params, vae_params, enc, dgf,
                       cond_img: torch.Tensor, eeg, ppg, fnirs, motion,
                       latents: torch.Tensor, img_ids: torch.Tensor,
                       cond_ids: torch.Tensor, sigmas: np.ndarray,
                       guidance: Optional[torch.Tensor],
                       c_factor: Optional[float],
                       cond_noise: Optional[torch.Tensor], *,
                       flux_cfg: FluxConfig, vae_cfg, flags: Dict[str, Any],
                       s4_mode: str, lat_h: int, lat_w: int,
                       w8a8: bool = False) -> torch.Tensor:
    """Brain encode (replace mode) + condition VAE encode + denoise + VAE
    decode -> images [B, H, W, 3].  ``cond_img`` [B, H, W, 3] in [-1, 1];
    ``cond_noise``: standard-normal draw of the latent's shape for the VAE
    sample, or None for the deterministic mean."""
    dtype = latents.dtype
    brain_prompt, brain_pooled = brain_encode(enc, dgf, eeg, ppg, fnirs,
                                              motion, s4_mode)
    prompt_embeds = brain_prompt.to(dtype)
    pooled = brain_pooled.to(dtype)
    b = latents.shape[0]
    if prompt_embeds.shape[0] == 1 and b > 1:
        prompt_embeds = prompt_embeds.expand(b, *prompt_embeds.shape[1:])
        pooled = pooled.expand(b, *pooled.shape[1:])
    txt_ids = torch.zeros(prompt_embeds.shape[1], 3, dtype=torch.float32,
                          device=latents.device)

    mean, logvar = vae_encode(vae_params, vae_cfg, cond_img.to(dtype))
    lat = vae_sample(mean, logvar, cond_noise) if cond_noise is not None else mean
    cond_tokens = pack_latents(scale_latents(vae_cfg, lat)).to(dtype)
    if cond_tokens.shape[0] == 1 and b > 1:
        cond_tokens = cond_tokens.expand(b, *cond_tokens.shape[1:])

    out = denoise(flux_params, flux_cfg, flags, latents, prompt_embeds, pooled,
                  img_ids, txt_ids, cond_tokens, cond_ids, sigmas, guidance,
                  c_factor, w8a8)
    lat = unscale_latents(vae_cfg, unpack_latents(out, lat_h, lat_w)).to(dtype)
    return vae_decode(vae_params, vae_cfg, lat)


def _apply_adapter_policy(pipeline, ctype: str) -> None:
    """Per-condition-type adapter switch: the registered adapter for
    ``ctype``, else the base weights (every adapter deactivated)."""
    if pipeline.adapters is None:
        return
    if ctype in pipeline.adapters:
        pipeline.set_adapters(ctype)
    elif pipeline.active_adapter is not None:
        pipeline.params["flux"] = pipeline.adapters.deactivate(
            pipeline.params["flux"])
        pipeline.active_adapter = None
        print(f"[neural_edit] no adapter registered for {ctype!r} — running "
              f"base weights (available: {pipeline.adapters.names()})")


def _to_numpy_image(img) -> np.ndarray:
    """PIL.Image | array [H, W, 3] (uint8 or float) -> float32 [-1, 1]."""
    if hasattr(img, "convert"):
        img = np.asarray(img.convert("RGB"))
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 127.5 - 1.0
    return img.astype(np.float32)


def neural_edit(pipeline, cond_image, *, eeg=None, ppg=None, fnirs=None,
                motion=None, condition_type: str = "eeg+fnirs",
                height: int = 512, width: int = 512,
                num_inference_steps: int = 28, guidance_scale: float = 3.5,
                seed: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                latents: Optional[torch.Tensor] = None,
                cond_noise: Optional[torch.Tensor] = None,
                position_delta: Optional[Tuple[int, int]] = None,
                position_scale: float = 1.0, condition_scale: float = 1.0,
                model_config: Optional[Dict[str, Any]] = None,
                s4_mode: str = "conv", output_type: str = "np",
                w8a8: bool = False):
    """The deployed neural edit (replace mode) on ``pipeline``'s device.

    ``cond_image``: PIL image or array [H, W, 3] / [B, H, W, 3] in [-1, 1]
    (uint8 is rescaled).  Needs both slot sources: eeg (prompt slot) and
    fnirs (pooled slot).  ``latents`` [B, S, C] and ``cond_noise`` (the VAE
    sample draw, [B, H/8, W/8, latent C]) default to standard normals from
    ``generator`` (seeded with ``seed``, default 0).  ``w8a8`` selects the
    W8A8 MAC mode of the int8 DiT.  Returns float32 numpy [B, H, W, 3]
    ("np") or uint8 ("uint8")."""
    if eeg is None or fnirs is None:
        raise ValueError(
            "neural_edit requires both eeg (prompt slot) and fnirs (pooled "
            "slot): the fused replace mode has no text embeds to back a "
            "missing slot. Use generate() for partial signal sets.")
    if condition_scale <= 0:
        raise ValueError(
            f"condition_scale={condition_scale} must be > 0 (log bias)")
    if output_type not in ("np", "uint8"):
        raise ValueError(
            f"output_type={output_type!r} — must be 'np' or 'uint8' (the "
            "fused program always decodes; use generate() for latents)")
    vae_scale = pipeline.vae_cfg.downscale
    if height % (2 * vae_scale) or width % (2 * vae_scale):
        raise ValueError(
            f"height/width must be multiples of {2 * vae_scale}, got "
            f"{height}x{width}")
    enc = pipeline.params.get("encoders")
    if enc is None:
        raise RuntimeError("pipeline has no biosignal encoders")
    dgf = pipeline.params.get("dgf")
    if dgf is None and ((eeg is not None and ppg is not None)
                        or (fnirs is not None and motion is not None)):
        raise RuntimeError(
            "pipeline.params has no 'dgf' fusion module but the given "
            "signal pairs require pairwise DGF fusion (partial checkpoint?)")
    _apply_adapter_policy(pipeline, condition_type)

    device = pipeline.device
    img = _to_numpy_image(cond_image)
    if img.ndim == 3:
        img = img[None]

    def to_tensor(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x, np.float32), device=device).to(pipeline.dtype)

    eeg, ppg, fnirs, motion = map(to_tensor, (eeg, ppg, fnirs, motion))
    b = max(eeg.shape[0], fnirs.shape[0])
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            0 if seed is None else seed)
    lat_h, lat_w = height // vae_scale, width // vae_scale
    s_img, c_in = (lat_h // 2) * (lat_w // 2), pipeline.flux_cfg.in_channels
    if latents is None:
        latents = torch.randn(b, s_img, c_in, generator=generator,
                              device=device)
    latents = latents.to(device=device, dtype=pipeline.dtype)
    c_lat_h, c_lat_w = img.shape[1] // vae_scale, img.shape[2] // vae_scale
    if cond_noise is None:
        cond_noise = torch.randn(img.shape[0], c_lat_h, c_lat_w,
                                 pipeline.vae_cfg.latent_channels,
                                 generator=generator, device=device)
    img_ids = latent_image_ids(lat_h, lat_w, device=device)
    cond_ids = shift_ids(latent_image_ids(c_lat_h, c_lat_w, device=device),
                         position_delta or (0, 0), position_scale)
    sigmas = flux_sigmas(num_inference_steps, s_img)
    guidance = (torch.full((b,), guidance_scale, dtype=torch.float32,
                           device=device)
                if pipeline.flux_cfg.guidance_embeds else None)
    c_factor = float(condition_scale) if condition_scale != 1.0 else None

    with torch.inference_mode():
        images = fused_edit_program(
            pipeline.params["flux"], pipeline.params["vae"], enc, dgf,
            torch.as_tensor(img, device=device), eeg, ppg, fnirs, motion,
            latents, img_ids, cond_ids, sigmas, guidance, c_factor,
            cond_noise.to(device), flux_cfg=pipeline.flux_cfg,
            vae_cfg=pipeline.vae_cfg, flags=dict(model_config or {}),
            s4_mode=s4_mode, lat_h=lat_h, lat_w=lat_w, w8a8=w8a8)
    images = images.float().cpu().numpy()
    if output_type == "uint8":
        images = ((np.clip(images, -1, 1) + 1) * 127.5).round().astype(np.uint8)
    return images
