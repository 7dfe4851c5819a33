"""Latent token packing and position ids (counterpart of
``loongx_tpu/ops/latents.py``), NHWC latents like the JAX package."""

from __future__ import annotations

import torch


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] latent grid -> [B, (H//2)*(W//2), C*4] tokens, each token
    laid out (c, dy, dx) like diffusers ``_pack_latents``."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of `pack_latents`: [B, S, C*4] -> [B, h, w, C]."""
    b, _, d = tokens.shape
    c = d // 4
    x = tokens.reshape(b, h // 2, w // 2, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h, w, c)


def latent_image_ids(h: int, w: int, device="cuda") -> torch.Tensor:
    """[(h//2)*(w//2), 3] float32 ids (0, row, col) over the token grid."""
    ids = torch.zeros(h // 2, w // 2, 3, dtype=torch.float32, device=device)
    ids[:, :, 1] += torch.arange(h // 2, dtype=torch.float32,
                                 device=device)[:, None]
    ids[:, :, 2] += torch.arange(w // 2, dtype=torch.float32,
                                 device=device)[None, :]
    return ids.reshape(-1, 3)


def shift_ids(ids: torch.Tensor, position_delta: tuple = (0, 0),
              position_scale: float = 1.0) -> torch.Tensor:
    """Condition-token position delta / scale transform."""
    ids = ids.clone()
    ids[:, 1] += float(position_delta[0])
    ids[:, 2] += float(position_delta[1])
    if position_scale != 1.0:
        scale_bias = (position_scale - 1.0) / 2.0
        ids[:, 1:3] *= position_scale
        ids[:, 1:3] += scale_bias
    return ids
