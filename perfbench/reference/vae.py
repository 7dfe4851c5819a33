"""Plain float32 AutoencoderKL (the FLUX VAE) on the tree of
`layout.vae_layout`: NHWC at the boundary, HWIO kernels, group norms with
eps 1e-6, the encoder's (0, 1, 0, 1) pad before each stride-2 conv, nearest
2x upsampling, one single-head attention in each mid block.  Nothing here
imports the measured package."""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

Tree = Dict[str, Any]


def _conv(p: Tree, x, stride: int = 1, padding=None):
    w = p["kernel"].float().permute(3, 2, 0, 1)
    if padding is None:
        padding = w.shape[-1] // 2
    return F.conv2d(x, w, p["bias"].float(), stride=stride, padding=padding)


def _gn(p: Tree, x, groups: int):
    return F.group_norm(x, groups, p["weight"].float(), p["bias"].float(), 1e-6)


def _resnet(p: Tree, x, g: int):
    h = _conv(p["conv1"], F.silu(_gn(p["norm1"], x, g)))
    h = _conv(p["conv2"], F.silu(_gn(p["norm2"], h, g)))
    return (_conv(p["shortcut"], x) if "shortcut" in p else x) + h


def _attn(p: Tree, x, g: int):
    b, c, h, w = x.shape
    y = _gn(p["norm"], x, g)

    def tokens(t):
        return t.permute(0, 2, 3, 1).reshape(b, h * w, c)

    q, k, v = (tokens(_conv(p[n], y)) for n in ("to_q", "to_k", "to_v"))
    probs = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), -1)
    out = (probs @ v).reshape(b, h, w, c).permute(0, 3, 1, 2)
    return x + _conv(p["to_out"], out)


def encode(params: Tree, cfg: Dict[str, Any], images: torch.Tensor):
    """images [B, H, W, 3] in [-1, 1] -> (mean, logvar) [B, H/8, W/8, C]."""
    p, g = params["encoder"], cfg["norm_num_groups"]
    x = _conv(p["conv_in"], images.float().permute(0, 3, 1, 2))
    n = len(cfg["block_out_channels"])
    for i in range(n):
        block = p[f"down_{i}"]
        for j in range(cfg["layers_per_block"]):
            x = _resnet(block[f"resnet_{j}"], x, g)
        if "downsample" in block:
            x = _conv(block["downsample"], F.pad(x, (0, 1, 0, 1)), 2, 0)
    x = _resnet(p["mid"]["resnet_0"], x, g)
    x = _attn(p["mid"]["attn"], x, g)
    x = _resnet(p["mid"]["resnet_1"], x, g)
    x = _conv(p["conv_out"], F.silu(_gn(p["norm_out"], x, g)))
    mean, logvar = x.permute(0, 2, 3, 1).chunk(2, -1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def decode(params: Tree, cfg: Dict[str, Any], lat: torch.Tensor):
    """latents [B, h, w, C] (VAE space) -> images [B, 8h, 8w, 3]."""
    p, g = params["decoder"], cfg["norm_num_groups"]
    x = _conv(p["conv_in"], lat.float().permute(0, 3, 1, 2))
    x = _resnet(p["mid"]["resnet_0"], x, g)
    x = _attn(p["mid"]["attn"], x, g)
    x = _resnet(p["mid"]["resnet_1"], x, g)
    for i in range(len(cfg["block_out_channels"])):
        block = p[f"up_{i}"]
        for j in range(cfg["layers_per_block"] + 1):
            x = _resnet(block[f"resnet_{j}"], x, g)
        if "upsample" in block:
            x = _conv(block["upsample"], F.interpolate(x, scale_factor=2,
                                                       mode="nearest"))
    x = _conv(p["conv_out"], F.silu(_gn(p["norm_out"], x, g)))
    return x.permute(0, 2, 3, 1)
