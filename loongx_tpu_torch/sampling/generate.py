"""Generation (counterpart of ``loongx_tpu/sampling/generate.py``): the
deployed neural edit -- CS3 + DGF brain encode (replace mode) ->
condition-image VAE encode -> flow-match Euler denoise over the DiT -> VAE
decode (`fused_edit_program`, `neural_edit`) -- and the full `generate()`:
text prompts through T5 and CLIP, brain conditions fused into them
(``fuse_flag``, the infer and train wirings) or replacing them, a
`Condition` or precomputed condition tokens, and the per-condition-type
adapter policy.

PyTorch runs eagerly, so the denoise loop is a Python loop over the sigma
pairs and "fused" only means one function.  Random draws (latents, the VAE
sample noise) are explicit inputs or come from a ``torch.Generator``: the
JAX package's ``jax.random`` streams cannot be reproduced here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from loongx_tpu_torch.models.encoders import (
    eeg_encode, fnirs_encode, motion_encode, ppg_encode,
)
from loongx_tpu_torch.models.flux.model import FluxConfig, flux_forward
from loongx_tpu_torch.models.flux.vae import (
    scale_latents, unscale_latents, vae_decode, vae_encode, vae_sample,
)
from loongx_tpu_torch.models.fusion import (
    fuse_eeg_ppg, fuse_fnirs_motion, fuse_text_infer, fuse_text_train,
)
from loongx_tpu_torch.models.hidream.model import (
    HiDreamConfig, hidream_forward, pack_patches, project_text, unpack_patches,
)
from loongx_tpu_torch.ops.latents import (
    latent_image_ids, pack_latents, shift_ids, unpack_latents,
)
from loongx_tpu_torch.ops.schedule import (
    euler_step, flux_sigmas, static_shift_sigmas,
)
from loongx_tpu_torch.sampling.condition import Condition, _to_numpy_image
from loongx_tpu_torch.utils.profiling import span


def denoise(flux_params, flux_cfg: Union[FluxConfig, HiDreamConfig],
            flags: Dict[str, Any],
            latents: torch.Tensor, txt: torch.Tensor, pooled: torch.Tensor,
            img_ids: torch.Tensor, txt_ids: torch.Tensor,
            cond: Optional[torch.Tensor], cond_ids: Optional[torch.Tensor],
            sigmas: np.ndarray, guidance: Optional[torch.Tensor],
            c_factor: Optional[float], w8a8: bool = False,
            int8_attn: bool = False, fuse_ln: bool = False,
            fuse_gate: bool = False,
            text_streams: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The denoise loop; sigmas [steps + 1] float32 (host), the DiT's
    timestep is sigma itself.  The DiT is the one ``flux_cfg`` names: for a
    `HiDreamConfig`, `hidream_forward` with its caption projections of the
    T5 slot and the Llama streams (``text_streams`` [B, 48, S, 4096]) made
    once, ahead of the steps, and the Euler step taking -out (the
    published pipeline's velocity).  Spans: ``edit.denoise``, and
    ``edit.denoise.step`` a step."""
    lat = latents
    with span("edit.denoise"):
        if isinstance(flux_cfg, HiDreamConfig):
            if fuse_ln or fuse_gate:
                raise ValueError("the HiDream DiT has no fused elementwise "
                                 "forms (fuse_ln / fuse_gate)")
            projected = project_text(flux_params, flux_cfg, txt, text_streams,
                                     w8a8)
        for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
            with span("edit.denoise.step"):
                t = torch.full((lat.shape[0],), float(sigma),
                               dtype=torch.float32, device=lat.device)
                if isinstance(flux_cfg, HiDreamConfig):
                    v = -hidream_forward(
                        flux_params, flux_cfg, img=lat.to(txt.dtype), txt=txt,
                        pooled=pooled, timestep=t, img_ids=img_ids, cond=cond,
                        cond_ids=cond_ids, flags=flags, c_factor=c_factor,
                        w8a8=w8a8, int8_attn=int8_attn, projected=projected)
                else:
                    v = flux_forward(
                        flux_params, flux_cfg, img=lat.to(txt.dtype), txt=txt,
                        pooled=pooled, timestep=t, guidance=guidance,
                        img_ids=img_ids, txt_ids=txt_ids, cond=cond,
                        cond_ids=cond_ids, flags=flags, c_factor=c_factor,
                        w8a8=w8a8, int8_attn=int8_attn, fuse_ln=fuse_ln,
                        fuse_gate=fuse_gate)
                lat = euler_step(lat, v, sigma, sigma_next)
    return lat


def brain_encode(enc, dgf, eeg, ppg, fnirs, motion, s4_mode: str = "conv"
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Biosignals -> (brain prompt [B, 512, 4096] | None, brain pooled
    [B, 768] | None): eeg(+ppg) fill the prompt slot, fnirs(+motion) the
    pooled slot.  Span: ``edit.brain_encode``."""
    with span("edit.brain_encode"):
        brain_prompt = None
        if eeg is not None:
            eeg_feat = eeg_encode(enc["eeg"], eeg, s4_mode)
            if ppg is not None:
                brain_prompt = fuse_eeg_ppg(
                    dgf, eeg_feat, ppg_encode(enc["ppg"], ppg, s4_mode))
            else:
                brain_prompt = eeg_feat
        brain_pooled = None
        if fnirs is not None:
            fnirs_feat = fnirs_encode(enc["fnirs"], fnirs, s4_mode)
            if motion is not None:
                brain_pooled = fuse_fnirs_motion(
                    dgf, fnirs_feat,
                    motion_encode(enc["motion"], motion, s4_mode))
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
                       flux_cfg: Union[FluxConfig, HiDreamConfig], vae_cfg,
                       flags: Dict[str, Any],
                       s4_mode: str, lat_h: int, lat_w: int,
                       w8a8: bool = False, int8_attn: bool = False,
                       fuse_ln: bool = False,
                       fuse_gate: bool = False,
                       text_streams: Optional[torch.Tensor] = None,
                       pooled_extra: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Brain encode (replace mode) + condition VAE encode + denoise + VAE
    decode -> images [B, H, W, 3].  ``cond_img`` [B, H, W, 3] in [-1, 1];
    ``cond_noise``: standard-normal draw of the latent's shape for the VAE
    sample, or None for the deterministic mean.  A HiDream DiT takes the
    brain prompt in its T5 slot, the brain pooled vector as the CLIP-L
    part of its pooled input, then ``pooled_extra`` [B, 1280] (the CLIP-G
    part), the 48 Llama streams ``text_streams``, and its own patch order
    (`pack_patches`); both are None for FLUX."""
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

    hidream = isinstance(flux_cfg, HiDreamConfig)
    if hidream:
        pooled = torch.cat([pooled, pooled_extra.to(dtype)], dim=-1)
    pack, unpack = ((pack_patches, unpack_patches) if hidream
                    else (pack_latents, unpack_latents))

    mean, logvar = vae_encode(vae_params, vae_cfg, cond_img.to(dtype))
    lat = vae_sample(mean, logvar, cond_noise) if cond_noise is not None else mean
    cond_tokens = pack(scale_latents(vae_cfg, lat)).to(dtype)
    if cond_tokens.shape[0] == 1 and b > 1:
        cond_tokens = cond_tokens.expand(b, *cond_tokens.shape[1:])

    out = denoise(flux_params, flux_cfg, flags, latents, prompt_embeds, pooled,
                  img_ids, txt_ids, cond_tokens, cond_ids, sigmas, guidance,
                  c_factor, w8a8, int8_attn, fuse_ln, fuse_gate,
                  text_streams=text_streams)
    lat = unscale_latents(vae_cfg, unpack(out, lat_h, lat_w)).to(dtype)
    return vae_decode(vae_params, vae_cfg, lat)


def encode_brain_conditions(pipeline, eeg=None, fnirs=None, ppg=None,
                            motion=None, s4_mode: str = "conv"
                            ) -> Tuple[Optional[torch.Tensor],
                                       Optional[torch.Tensor]]:
    """Biosignals (arrays or tensors) -> (brain prompt [B, 512, 4096] |
    None, brain pooled [B, 768] | None) through CS3 and the pairwise DGF,
    on the pipeline's device; ``s4_mode`` as in `neural_edit`."""
    enc = pipeline.params.get("encoders")
    dgf = pipeline.params.get("dgf")
    if enc is None:
        raise RuntimeError("pipeline has no biosignal encoders")
    missing = [name for name, sig in (("eeg", eeg), ("ppg", ppg),
                                      ("fnirs", fnirs), ("motion", motion))
               if sig is not None and name not in enc]
    if missing:
        raise RuntimeError(
            f"pipeline.params['encoders'] lacks {missing} but those signals "
            f"were given (partial checkpoint? present: {sorted(enc)})")
    needs_dgf = (eeg is not None and ppg is not None) or (
        fnirs is not None and motion is not None)
    if needs_dgf and dgf is None:
        raise RuntimeError(
            "pipeline.params has no 'dgf' fusion module but the given "
            "signal pairs (EEG+PPG / fNIRS+Motion) require pairwise DGF "
            "fusion (partial checkpoint?)")
    eeg, fnirs, ppg, motion = (_signal_tensor(pipeline, x)
                               for x in (eeg, fnirs, ppg, motion))
    with torch.inference_mode():
        return brain_encode(enc, dgf, eeg, ppg, fnirs, motion, s4_mode)


def _signal_tensor(pipeline, x) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x)
                           else x, device=pipeline.device).to(pipeline.dtype)


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
        print(f"[generate] no adapter registered for {ctype!r} — running "
              f"base weights (available: {pipeline.adapters.names()})")


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
                w8a8: bool = False, int8_attn: bool = False,
                fuse_ln: bool = False, fuse_gate: bool = False,
                text_streams=None, pooled_extra=None):
    """The deployed neural edit (replace mode) on ``pipeline``'s device.

    ``cond_image``: PIL image or array [H, W, 3] / [B, H, W, 3] in [-1, 1]
    (uint8 is rescaled).  Needs both slot sources: eeg (prompt slot) and
    fnirs (pooled slot).  ``latents`` [B, S, C] and ``cond_noise`` (the VAE
    sample draw, [B, H/8, W/8, latent C]) default to standard normals from
    ``generator`` (seeded with ``seed``, default 0).  ``w8a8`` selects the
    W8A8 MAC mode of the int8 DiT, ``int8_attn`` the int8 QK^T attention
    scores, ``fuse_ln`` / ``fuse_gate`` the LN + adaLN prologue / gate +
    residual epilogue inside the int8 kernels (batch 1), ``s4_mode`` the
    S4D core of the encoders ("conv", "scan" or "pallas", the recurrence
    kernel).  A pipeline holding a `HiDreamConfig` also needs the text
    encoders' outputs that the brain signals do not replace:
    ``text_streams`` [B, 48, S, 4096] (the Llama-3.1 layers' states) and
    ``pooled_extra`` [B, 1280] (CLIP-G pooled); it samples HiDream-I1-Dev's
    static-shift sigmas (`static_shift_sigmas`) without guidance.  Returns
    float32 numpy [B, H, W, 3]
    ("np") or uint8 ("uint8").  Span: ``edit.request``, the root of the
    stage spans."""
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
    hidream = isinstance(pipeline.flux_cfg, HiDreamConfig)
    if hidream and (text_streams is None or pooled_extra is None):
        raise ValueError(
            "a HiDream DiT needs text_streams (the Llama layers' states) and "
            "pooled_extra (CLIP-G pooled): the brain signals fill only its "
            "T5 slot and the CLIP-L part of its pooled input")
    enc = pipeline.params.get("encoders")
    if enc is None:
        raise RuntimeError("pipeline has no biosignal encoders")
    dgf = pipeline.params.get("dgf")
    if dgf is None and ((eeg is not None and ppg is not None)
                        or (fnirs is not None and motion is not None)):
        raise RuntimeError(
            "pipeline.params has no 'dgf' fusion module but the given "
            "signal pairs require pairwise DGF fusion (partial checkpoint?)")
    with span("edit.request"):
        _apply_adapter_policy(pipeline, condition_type)

        device = pipeline.device
        img = _to_numpy_image(cond_image)
        if img.ndim == 3:
            img = img[None]

        eeg, ppg, fnirs, motion = (_signal_tensor(pipeline, x)
                                   for x in (eeg, ppg, fnirs, motion))
        b = max(eeg.shape[0], fnirs.shape[0])
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(
                0 if seed is None else seed)
        lat_h, lat_w = height // vae_scale, width // vae_scale
        s_img = (lat_h // 2) * (lat_w // 2)
        c_in = pipeline.flux_cfg.in_channels
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
        sigmas = (static_shift_sigmas(num_inference_steps) if hidream
                  else flux_sigmas(num_inference_steps, s_img))
        guidance = (torch.full((b,), guidance_scale, dtype=torch.float32,
                               device=device)
                    if pipeline.flux_cfg.guidance_embeds else None)
        c_factor = float(condition_scale) if condition_scale != 1.0 else None
        hidream_inputs = {}
        if hidream:
            hidream_inputs = {
                "text_streams": _as_device_tensor(text_streams, device,
                                                  pipeline.dtype),
                "pooled_extra": _as_device_tensor(pooled_extra, device,
                                                  pipeline.dtype)}

        with torch.inference_mode():
            images = fused_edit_program(
                pipeline.params["flux"], pipeline.params["vae"], enc, dgf,
                torch.as_tensor(img, device=device), eeg, ppg, fnirs, motion,
                latents, img_ids, cond_ids, sigmas, guidance, c_factor,
                cond_noise.to(device), flux_cfg=pipeline.flux_cfg,
                vae_cfg=pipeline.vae_cfg, flags=dict(model_config or {}),
                s4_mode=s4_mode, lat_h=lat_h, lat_w=lat_w, w8a8=w8a8,
                int8_attn=int8_attn, fuse_ln=fuse_ln, fuse_gate=fuse_gate,
                **hidream_inputs)
        images = images.float().cpu().numpy()
        if output_type == "uint8":
            images = ((np.clip(images, -1, 1) + 1) * 127.5).round().astype(
                np.uint8)
        return images


def _as_device_tensor(x, device, dtype=None) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype or t.dtype)


def generate(pipeline, prompt: Union[str, Sequence[str], None] = None,
             conditions: Optional[List[Condition]] = None, *,
             condition_type: Optional[str] = None, height: int = 512,
             width: int = 512, num_inference_steps: int = 28,
             guidance_scale: float = 3.5, seed: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             latents: Optional[torch.Tensor] = None,
             cond_noise: Optional[torch.Tensor] = None,
             prompt_embeds: Optional[torch.Tensor] = None,
             pooled_prompt_embeds: Optional[torch.Tensor] = None,
             condition_scale: float = 1.0,
             cond_tokens: Optional[torch.Tensor] = None,
             cond_ids: Optional[torch.Tensor] = None, eeg=None, fnirs=None,
             ppg=None, motion=None, use_brain_condition: bool = False,
             fuse_flag: bool = False, neural_only: bool = False,
             fuse_mode: str = "infer",
             model_config: Optional[Dict[str, Any]] = None,
             output_type: str = "np", decode_chunk: Optional[int] = None,
             w8a8: bool = False, int8_attn: bool = False,
             fuse_ln: bool = False, fuse_gate: bool = False):
    """Neural-driven image editing / generation on ``pipeline``'s device.

    ``eeg`` / ``fnirs`` / ``ppg`` / ``motion`` are the reference's
    additional conditions 1-4 (or ride on ``conditions[0]``);
    ``fuse_flag=False`` replaces the text embeds with the brain embeds (the
    deployed mode), ``fuse_flag=True`` fuses them by the ``fuse_mode``
    wiring ("infer" or "train").  ``condition_type`` drives the adapter
    switch on the precomputed ``cond_tokens`` path (a Condition brings its
    own type).  ``decode_chunk`` bounds how many images a decode step
    takes (None: all of them); `vae_decode` runs one image a pass either
    way, so the images do not depend on it.  ``w8a8``, ``int8_attn``, ``fuse_ln`` and ``fuse_gate`` select
    the int8 DiT's MAC mode, attention scores and fused elementwise work,
    as in `neural_edit`.

    Random draws: ``latents`` [B, S, C] and ``cond_noise`` (the condition
    VAE sample's standard normals, [1, H/8, W/8, latent C]) default to
    normals from ``generator`` (seeded with ``seed``, default 0), latents
    first.  Returns float32 numpy [B, H, W, 3] in [-1, 1] ("np"), uint8
    ("uint8") or the packed latents as a tensor ("latent").  Span:
    ``edit.request``, around the stages' spans."""
    if isinstance(pipeline.flux_cfg, HiDreamConfig):
        raise NotImplementedError(
            "generate() runs the FLUX DiT; serve a HiDream DiT through "
            "neural_edit (its Llama and CLIP-G encoders are not ported)")
    if fuse_mode not in ("infer", "train"):
        raise ValueError(
            f"fuse_mode={fuse_mode!r} — must be 'infer' or 'train' (the two "
            "documented DUAN wirings, SURVEY §2b); anything else would "
            "silently select the train wiring")
    if output_type not in ("np", "uint8", "latent"):
        raise ValueError(
            f"output_type={output_type!r} — must be 'np', 'uint8', or "
            "'latent'")
    if condition_scale <= 0:
        raise ValueError(
            f"condition_scale={condition_scale} must be > 0: it enters the "
            "attention as a log bias (log(0)=-inf, log(<0)=NaN would "
            "silently poison every denoise step)")
    if conditions and cond_tokens is not None:
        raise ValueError(
            "pass either `conditions` or precomputed `cond_tokens`, not "
            "both — the Condition encode would silently overwrite the "
            "precomputed tokens")
    vae_scale = pipeline.vae_cfg.downscale
    if height % (2 * vae_scale) or width % (2 * vae_scale):
        raise ValueError(
            f"height/width must be multiples of {2 * vae_scale} (VAE "
            f"downscale x 2x2 latent pack), got {height}x{width}")
    device, dtype = pipeline.device, pipeline.dtype
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            0 if seed is None else seed)

    with span("edit.request"), torch.inference_mode():
        # ---- brain conditions (first: in replacement mode they can cover
        # both text slots, and the text encode is skipped) ----
        brain_prompt = brain_pooled = None
        if use_brain_condition:
            if conditions:
                c0 = conditions[0]
                eeg = eeg if eeg is not None else c0.eeg
                fnirs = fnirs if fnirs is not None else c0.fnirs
                ppg = ppg if ppg is not None else c0.ppg
                motion = motion if motion is not None else c0.motion
            if ppg is not None and eeg is None:
                print("[generate] WARNING: ppg given without eeg — PPG fuses "
                      "into the prompt slot only alongside EEG; it is ignored")
            if motion is not None and fnirs is None:
                print("[generate] WARNING: motion given without fnirs — "
                      "Motion fuses into the pooled slot only alongside "
                      "fNIRS; it is ignored")
            if eeg is None and fnirs is None and ppg is None and motion is None:
                raise ValueError(
                    "use_brain_condition=True but no biosignals were given "
                    "(eeg/fnirs/ppg/motion all None, on the kwargs and on the "
                    "Condition) — the call would silently degrade to "
                    "text-only generation")
            brain_prompt, brain_pooled = encode_brain_conditions(
                pipeline, eeg=eeg, fnirs=fnirs, ppg=ppg, motion=motion)
        elif conditions and conditions[0].condition is None and any(
                x is not None for x in (conditions[0].eeg, conditions[0].fnirs,
                                        conditions[0].ppg, conditions[0].motion)):
            raise ValueError(
                "the Condition carries biosignals and no condition image, but "
                "use_brain_condition=False — nothing of it would be used. "
                "Pass use_brain_condition=True (the deployed neural mode) or "
                "give the Condition a source image")

        # ---- text embeddings ----
        text_zeroed = False
        if prompt_embeds is None:
            if neural_only and not (use_brain_condition and not fuse_flag):
                raise ValueError(
                    "neural_only=True requires use_brain_condition=True and "
                    "fuse_flag=False (brain embeds must replace the zeroed "
                    "text embeds); got use_brain_condition="
                    f"{use_brain_condition}, fuse_flag={fuse_flag}")
            if (not fuse_flag and brain_prompt is not None
                    and brain_pooled is not None):
                # replacement with both slots covered: skip the text encode
                prompt_embeds = brain_prompt.to(dtype)
                pooled_prompt_embeds = brain_pooled.to(dtype)
            else:
                text_zeroed = neural_only and (
                    pipeline.t5_tokenizer is None
                    or pipeline.clip_tokenizer is None)
                prompt_embeds, pooled_prompt_embeds, _ = pipeline.encode_text(
                    prompt, neural_only=neural_only)
        else:
            if pooled_prompt_embeds is None:
                raise ValueError(
                    "prompt_embeds given without pooled_prompt_embeds — both "
                    "are required (pooled feeds the adaLN timestep "
                    "embedding)")
            prompt_embeds = _as_device_tensor(prompt_embeds, device)
            pooled_prompt_embeds = _as_device_tensor(pooled_prompt_embeds,
                                                     device)
        batch = prompt_embeds.shape[0]

        # ---- brain fusion / replacement ----
        if use_brain_condition:
            brain_bs = [x.shape[0] for x in (brain_prompt, brain_pooled)
                        if x is not None]
            if brain_bs and max(brain_bs) > 1:
                bb = max(brain_bs)
                if prompt_embeds.shape[0] == 1:
                    prompt_embeds = prompt_embeds.expand(
                        bb, *prompt_embeds.shape[1:])
                if pooled_prompt_embeds.shape[0] == 1:
                    pooled_prompt_embeds = pooled_prompt_embeds.expand(
                        bb, *pooled_prompt_embeds.shape[1:])
            if fuse_flag:
                if brain_prompt is None and brain_pooled is not None:
                    raise ValueError(
                        "fuse_flag=True with fNIRS/Motion but no EEG: neither "
                        "fusion wiring can fuse a pooled brain embed without "
                        "a prompt brain embed (models/fusion.py)")
                if (brain_prompt is not None and brain_pooled is None
                        and fuse_mode == "infer"):
                    raise ValueError(
                        "fuse_flag=True with partial brain signals (no "
                        "fNIRS): the infer fusion wiring needs both slots — "
                        "provide fnirs or use fuse_mode='train', whose "
                        "pooled branch is optional")
                if brain_prompt is not None:
                    dgf = pipeline.params.get("dgf")
                    if dgf is None:
                        raise RuntimeError(
                            "fuse_flag=True but pipeline.params has no 'dgf' "
                            "fusion module (partial checkpoint?)")
                    want_tok = dgf["duan_prompt"]["gate_in"]["kernel"].shape[0]
                    if prompt_embeds.shape[1] != want_tok:
                        raise ValueError(
                            f"fuse_flag=True needs prompt_embeds with exactly "
                            f"{want_tok} tokens (the DGF's DUAN channel "
                            f"count); got {prompt_embeds.shape[1]}. Encode "
                            f"prompts at max_sequence_length={want_tok}, or "
                            "use the replacement mode (fuse_flag=False)")
                    fuse_fn = (fuse_text_infer if fuse_mode == "infer"
                               else fuse_text_train)
                    prompt_embeds, pooled_prompt_embeds = fuse_fn(
                        dgf, prompt_embeds, pooled_prompt_embeds,
                        brain_prompt, brain_pooled)
            else:
                if brain_prompt is not None:
                    prompt_embeds = brain_prompt.to(dtype)
                if brain_pooled is not None:
                    pooled_prompt_embeds = brain_pooled.to(dtype)
                if text_zeroed and (brain_prompt is None
                                    or brain_pooled is None):
                    missing = [n for n, v in (("prompt (EEG)", brain_prompt),
                                              ("pooled (fNIRS)", brain_pooled))
                               if v is None]
                    raise RuntimeError(
                        "neural_only=True but brain signals do not cover: "
                        + ", ".join(missing)
                        + " — the corresponding zero text embedding would "
                        "silently destroy conditioning. Provide those signals "
                        "or load text tokenizers.")
            # replacement can widen the batch (one empty prompt, a batch of
            # signals): broadcast any remaining singleton embed
            b_p, b_pool = prompt_embeds.shape[0], pooled_prompt_embeds.shape[0]
            batch = max(b_p, b_pool)
            if b_p != batch or b_pool != batch:
                if 1 not in (b_p, b_pool):
                    raise ValueError(
                        f"prompt embeds batch {b_p} vs pooled embeds batch "
                        f"{b_pool}: brain signals must share one batch size")
                prompt_embeds = prompt_embeds.expand(batch,
                                                     *prompt_embeds.shape[1:])
                pooled_prompt_embeds = pooled_prompt_embeds.expand(
                    batch, *pooled_prompt_embeds.shape[1:])
        txt_ids = torch.zeros(prompt_embeds.shape[1], 3, dtype=torch.float32,
                              device=device)

        # ---- latents ----
        lat_h, lat_w = height // vae_scale, width // vae_scale
        s_img = (lat_h // 2) * (lat_w // 2)
        c_in = pipeline.flux_cfg.in_channels
        if latents is not None:
            if (latents.ndim != 3 or tuple(latents.shape[1:]) != (s_img, c_in)
                    or latents.shape[0] != batch):
                raise ValueError(
                    f"latents shape {tuple(latents.shape)} does not match "
                    f"height={height}, width={width}, batch={batch}: expected "
                    f"[{batch}, {s_img}, {c_in}] packed latent tokens "
                    f"((h/{vae_scale}/2)*(w/{vae_scale}/2) tokens, batch from "
                    f"the prompt embeddings)")
        else:
            latents = torch.randn(batch, s_img, c_in, generator=generator,
                                  device=device)
        latents = _as_device_tensor(latents, device, dtype)
        img_ids = latent_image_ids(lat_h, lat_w, device=device)

        # ---- condition tokens ----
        if conditions:
            if len(conditions) > 1:
                raise NotImplementedError("only one condition supported (parity)")
            cond = conditions[0]
            _apply_adapter_policy(pipeline, cond.condition_type)
            if cond.condition is not None:
                if cond_noise is None:
                    img = _to_numpy_image(cond.condition)
                    cond_noise = torch.randn(
                        1, img.shape[0] // vae_scale, img.shape[1] // vae_scale,
                        pipeline.vae_cfg.latent_channels, generator=generator,
                        device=device)
                toks, cond_ids, _ = cond.encode(
                    pipeline, noise=_as_device_tensor(cond_noise, device))
                cond_tokens = toks.to(dtype).expand(batch, *toks.shape[1:])
            elif cond.condition_type != "eeg+fnirs":
                raise ValueError(
                    f"Condition({cond.condition_type!r}) has no condition "
                    "image — spatial condition types need raw_img or a "
                    "precomputed condition")
        elif cond_tokens is not None:
            if condition_type is not None:
                _apply_adapter_policy(pipeline, condition_type)
            if cond_ids is None:
                raise ValueError(
                    "cond_tokens given without cond_ids — precomputed "
                    "condition tokens need their RoPE position ids "
                    "(sampling/condition.py latent_image_ids + shift_ids)")
            cond_tokens = _as_device_tensor(cond_tokens, device, dtype)
            if cond_tokens.ndim == 2:
                cond_tokens = cond_tokens[None].expand(batch,
                                                       *cond_tokens.shape)
        if cond_ids is not None:
            cond_ids = _as_device_tensor(cond_ids, device, torch.float32)

        # ---- schedule and denoise ----
        sigmas = flux_sigmas(num_inference_steps, latents.shape[1])
        guidance = (torch.full((batch,), guidance_scale, dtype=torch.float32,
                               device=device)
                    if pipeline.flux_cfg.guidance_embeds else None)
        c_factor = float(condition_scale) if condition_scale != 1.0 else None
        out = denoise(pipeline.params["flux"], pipeline.flux_cfg,
                      dict(model_config or {}), latents, prompt_embeds,
                      pooled_prompt_embeds, img_ids, txt_ids, cond_tokens,
                      cond_ids, sigmas, guidance, c_factor, w8a8, int8_attn,
                      fuse_ln, fuse_gate)
        if output_type == "latent":
            return out

        # ---- decode ----
        lat = unscale_latents(pipeline.vae_cfg,
                              unpack_latents(out, lat_h, lat_w)).to(dtype)
        chunk = (decode_chunk if decode_chunk is not None
                 and 0 < decode_chunk < lat.shape[0] else lat.shape[0])
        images = np.concatenate([
            vae_decode(pipeline.params["vae"], pipeline.vae_cfg,
                       lat[i:i + chunk]).float().cpu().numpy()
            for i in range(0, lat.shape[0], chunk)])
    if output_type == "uint8":
        images = ((np.clip(images, -1, 1) + 1) * 127.5).round().astype(np.uint8)
    return images
