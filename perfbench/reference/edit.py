"""The plain neural edit, float32 end to end: brain encode (CS3 + DGF) of
the four signals into the prompt slots, the condition image's VAE encode
and sample, the flow-matching Euler denoise over the W8A8 DiT (FLUX.1-dev's
shifted schedule, the condition tokens at position offset 0) and the VAE
decode.  Nothing here imports the measured package."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from perfbench.reference import brain, flux, vae


def flux_sigmas(steps: int, image_tokens: int) -> np.ndarray:
    """linspace(1, 1/n, n) under the dynamic exponential shift mu(tokens)
    (base 256 -> 0.5, max 4096 -> 1.15), then 0: float32 [n + 1]."""
    mu = 0.5 + (1.15 - 0.5) / (4096 - 256) * (image_tokens - 256)
    t = np.linspace(1.0, 1.0 / steps, steps)
    sigmas = np.exp(mu) / (np.exp(mu) + (1.0 / t - 1.0))
    return np.append(sigmas, 0.0).astype(np.float32)


def pack(lat: torch.Tensor) -> torch.Tensor:
    """[B, h, w, C] -> [B, (h/2)(w/2), 4C], each token laid out (c, dy, dx)."""
    b, h, w, c = lat.shape
    x = lat.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, d = tokens.shape
    x = tokens.reshape(b, h // 2, w // 2, d // 4, 2, 2).permute(0, 1, 4, 2,
                                                                   5, 3)
    return x.reshape(b, h, w, d // 4)


def image_ids(h: int, w: int, device) -> torch.Tensor:
    """[(h/2)(w/2), 3]: (0, row, col) over the token grid."""
    rows = torch.arange(h // 2, device=device, dtype=torch.float32)
    cols = torch.arange(w // 2, device=device, dtype=torch.float32)
    ids = torch.stack(torch.broadcast_tensors(
        torch.zeros(h // 2, w // 2, device=device), rows[:, None],
        cols[None, :]), -1)
    return ids.reshape(-1, 3)


def neural_edit(weights: Dict[str, Any], cfg: Dict[str, Any],
                inputs: Dict[str, torch.Tensor], steps: int, guidance: float,
                acts: str = "int8") -> torch.Tensor:
    """float32 images [B, H, W, 3] of the edit of ``inputs`` (the uint8
    condition image [B, H, W, 3], the signals, the latents draw [B, S, C]
    and the VAE-sample draw [B, H/8, W/8, C_lat]); ``acts`` the DiT's
    activation precision (`flux.Linears`: "int4" is the control)."""
    t, v = cfg["transformer"], cfg["vae"]
    dev = inputs["latents"].device
    img = inputs["image"].float() / 127.5 - 1.0
    b, hgt, wid = img.shape[:3]
    prompt, pooled = brain.brain_embeds(weights["brain"], inputs)
    mean, logvar = vae.encode(weights["vae"], v, img)
    lat = mean + torch.exp(0.5 * logvar) * inputs["cond_noise"].float()
    cond = pack((lat - v["shift_factor"]) * v["scaling_factor"])
    ds = 2 ** (len(v["block_out_channels"]) - 1)
    lat_h, lat_w = hgt // ds, wid // ds
    ids = image_ids(lat_h, lat_w, dev)
    txt_ids = torch.zeros(prompt.shape[1], 3, device=dev)
    lin = flux.Linears(acts)
    x = inputs["latents"].float()
    sigmas = flux_sigmas(steps, x.shape[1])
    g = torch.full((b,), guidance, device=dev)
    for s0, s1 in zip(sigmas[:-1], sigmas[1:]):
        vel = flux.flux_forward(
            weights["flux"], t, lin, img=x, txt=prompt, pooled=pooled,
            timestep=torch.full((b,), float(s0), device=dev), guidance=g,
            img_ids=ids, txt_ids=txt_ids, cond=cond, cond_ids=ids)
        x = x + float(np.float32(s1) - np.float32(s0)) * vel
    lat = unpack(x, lat_h, lat_w) / v["scaling_factor"] + v["shift_factor"]
    return vae.decode(weights["vae"], v, lat)
