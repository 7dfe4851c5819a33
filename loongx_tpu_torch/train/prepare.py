"""Batch preparation: host samples -> the train step's batch on the card
(counterpart of ``loongx_tpu/train/prepare.py``).

The frozen encoders run here, without gradients: the VAE encodes target
and condition images (the distribution's mean, no sampling), scaled and
packed into tokens; T5/CLIP encode the prompts unless a staged text cache
holds them; the biosignals are pooled to their fixed lengths; the
condition's position ids take the sample's position delta.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from loongx_tpu_torch.models.encoders import canonicalise_signal
from loongx_tpu_torch.models.flux.vae import scale_latents, vae_encode
from loongx_tpu_torch.ops.latents import latent_image_ids, pack_latents, shift_ids

TextCache = Tuple[Dict[str, Tuple[torch.Tensor, torch.Tensor]], torch.Tensor]


def _encode_images(pipeline, images: torch.Tensor) -> torch.Tensor:
    mean, _ = vae_encode(pipeline.params["vae"], pipeline.vae_cfg, images)
    return pack_latents(scale_latents(pipeline.vae_cfg, mean))


@torch.no_grad()
def build_text_cache(pipeline, descriptions, chunk: int = 8) -> TextCache:
    """Encode every prompt the dataset can emit (staged-text training).

    Returns ``({prompt: (embeds [S, D], pooled [D])}, txt_ids)`` on the
    host, so that the text encoders can be freed before the DiT is loaded.
    Each row is what ``encode_text`` returns for it (the fixed-length
    padding makes a row independent of its chunk), so staged training
    equals resident training.  "" is always cached: prompt dropout and
    missing descriptions fall back to it."""
    uniq = sorted(set(descriptions) | {""})
    cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    txt_ids = None
    for s in range(0, len(uniq), chunk):
        batch = uniq[s:s + chunk]
        emb, pooled, ids = pipeline.encode_text(batch)
        emb, pooled = emb.cpu(), pooled.cpu()
        for i, d in enumerate(batch):
            cache[d] = (emb[i], pooled[i])
        txt_ids = ids.cpu()
    return cache, txt_ids


@torch.no_grad()
def prepare_batch(pipeline, host_batch: Dict[str, Any],
                  position_scale: float = 1.0,
                  text_cache: Optional[TextCache] = None) -> Dict[str, Any]:
    """host_batch (from `data.loader.iterate_batches`): images in [0, 1]
    float32 NHWC, raw biosignals, descriptions.  Returns the train step's
    batch on the pipeline's device."""
    device, dtype = pipeline.device, pipeline.dtype
    ds = pipeline.vae_cfg.downscale
    imgs = torch.as_tensor(host_batch["image"], device=device) * 2.0 - 1.0
    conds = torch.as_tensor(host_batch["condition"], device=device) * 2.0 - 1.0
    x0 = _encode_images(pipeline, imgs.to(dtype))
    cond_tokens = _encode_images(pipeline, conds.to(dtype))
    img_ids = latent_image_ids(imgs.shape[1] // ds, imgs.shape[2] // ds,
                               device=device)
    delta = host_batch.get("position_delta")
    delta = (0, 0) if delta is None else tuple(np.asarray(delta)[0].tolist())
    cond_ids = shift_ids(latent_image_ids(conds.shape[1] // ds,
                                          conds.shape[2] // ds, device=device),
                         delta, position_scale)

    prompts = host_batch.get("description", [""] * imgs.shape[0])
    if text_cache is not None:
        cache, cached_ids = text_cache
        try:
            rows = [cache[p] for p in prompts]
        except KeyError as exc:
            raise KeyError(
                f"staged-text cache has no entry for prompt {exc}: the "
                "cache was built from dataset.descriptions() -- a dataset "
                "emitting prompts outside that set cannot train staged"
            ) from None
        prompt_embeds = torch.stack([r[0] for r in rows]).to(device)
        pooled = torch.stack([r[1] for r in rows]).to(device)
        txt_ids = cached_ids.to(device)
    else:
        prompt_embeds, pooled, txt_ids = pipeline.encode_text(list(prompts))

    batch = {
        "x0": x0.float(),
        "img_ids": img_ids,
        "txt_ids": txt_ids,
        "prompt_embeds": prompt_embeds,
        "pooled": pooled,
        "cond_tokens": cond_tokens,
        "cond_ids": cond_ids,
    }
    for name in ("eeg", "fnirs", "ppg", "motion"):
        if host_batch.get(name) is not None:
            sig = torch.as_tensor(host_batch[name], dtype=torch.float32,
                                  device=device)
            batch[name] = canonicalise_signal(sig, name)
    return batch
