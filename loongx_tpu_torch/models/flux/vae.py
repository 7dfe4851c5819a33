"""FLUX VAE (AutoencoderKL) in PyTorch (counterpart of
``loongx_tpu/models/flux/vae.py``).

NHWC at the boundary like the JAX package; conv weights stay HWIO as the JAX
tree stores them.  Inside, activations are NCHW views of NHWC memory
(channels_last), so no layout copy is made.  Convolutions are plain PyTorch
(the JAX package leaves them to XLA); group-norm statistics are float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from loongx_tpu_torch.ops.nn import Params, init_layer_norm, silu, uniform
from loongx_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    block_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_channels) - 1)

    @staticmethod
    def flux() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(latent_channels=4, block_channels=(8, 16),
                         layers_per_block=1, norm_groups=4)


# ---------------------------------------------------------------------------
# Init (random, the JAX package's layout)
# ---------------------------------------------------------------------------


def _init_conv(kh, kw, cin, cout, kw_args) -> Params:
    bound = 1.0 / math.sqrt(kh * kw * cin)
    return {"kernel": uniform((kh, kw, cin, cout), bound, **kw_args),
            "bias": uniform((cout,), bound, **kw_args)}


def _gn(c, kw) -> Params:
    return init_layer_norm(c, dtype=kw["dtype"], device=kw["device"])


def _init_resnet(cin, cout, kw) -> Params:
    p = {"norm1": _gn(cin, kw),
         "conv1": _init_conv(3, 3, cin, cout, kw),
         "norm2": _gn(cout, kw),
         "conv2": _init_conv(3, 3, cout, cout, kw)}
    if cin != cout:
        p["shortcut"] = _init_conv(1, 1, cin, cout, kw)
    return p


def _init_attn(c, kw) -> Params:
    p = {"norm": _gn(c, kw)}
    for name in ("to_q", "to_k", "to_v", "to_out"):
        p[name] = _init_conv(1, 1, c, c, kw)
    return p


def init_vae_params(cfg: VAEConfig, *, generator=None, dtype=torch.float32,
                    device="cuda") -> Params:
    kw = dict(generator=generator, dtype=dtype, device=device)
    ch = cfg.block_channels
    enc: Params = {"conv_in": _init_conv(3, 3, cfg.in_channels, ch[0], kw)}
    cin = ch[0]
    for i, cout in enumerate(ch):
        block = {f"resnet_{j}": _init_resnet(cin if j == 0 else cout, cout, kw)
                 for j in range(cfg.layers_per_block)}
        if i < len(ch) - 1:
            block["downsample"] = _init_conv(3, 3, cout, cout, kw)
        enc[f"down_{i}"] = block
        cin = cout
    enc["mid"] = {"resnet_0": _init_resnet(cin, cin, kw),
                  "attn": _init_attn(cin, kw),
                  "resnet_1": _init_resnet(cin, cin, kw)}
    enc["norm_out"] = _gn(cin, kw)
    enc["conv_out"] = _init_conv(3, 3, cin, 2 * cfg.latent_channels, kw)

    rch = tuple(reversed(ch))
    dec: Params = {"conv_in": _init_conv(3, 3, cfg.latent_channels, rch[0], kw)}
    dec["mid"] = {"resnet_0": _init_resnet(rch[0], rch[0], kw),
                  "attn": _init_attn(rch[0], kw),
                  "resnet_1": _init_resnet(rch[0], rch[0], kw)}
    cin = rch[0]
    for i, cout in enumerate(rch):
        block = {f"resnet_{j}": _init_resnet(cin if j == 0 else cout, cout, kw)
                 for j in range(cfg.layers_per_block + 1)}
        if i < len(rch) - 1:
            block["upsample"] = _init_conv(3, 3, cout, cout, kw)
        dec[f"up_{i}"] = block
        cin = cout
    dec["norm_out"] = _gn(cin, kw)
    dec["conv_out"] = _init_conv(3, 3, cin, cfg.in_channels, kw)
    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# Apply (x is NCHW-shaped, channels_last in memory)
# ---------------------------------------------------------------------------


def _conv(p: Params, x, stride: int = 1, padding: Optional[int] = None):
    """Conv in x's dtype with the bias added before the one rounding."""
    w = p["kernel"].permute(3, 2, 0, 1).to(x.dtype)  # HWIO -> OIHW view
    if padding is None:
        padding = w.shape[-1] // 2  # "SAME" for odd kernels at stride 1
    return F.conv2d(x, w, p["bias"].to(x.dtype), stride=stride,
                    padding=padding)


def _group_norm(p: Params, x, groups: int, eps: float = 1e-6):
    y = F.group_norm(x.float(), groups, p["weight"].float(), p["bias"].float(),
                     eps)
    return y.to(x.dtype)


def _resnet(p: Params, x, groups: int):
    h = _conv(p["conv1"], silu(_group_norm(p["norm1"], x, groups)))
    h = _conv(p["conv2"], silu(_group_norm(p["norm2"], h, groups)))
    if "shortcut" in p:
        x = _conv(p["shortcut"], x)
    return x + h


def _spatial_attn(p: Params, x, groups: int):
    """Single-head spatial self-attention over H*W (VAE mid block)."""
    b, c, h, w = x.shape
    y = _group_norm(p["norm"], x, groups)

    def tokens(t):  # [B, C, H, W] -> [B, H*W, C]
        return t.permute(0, 2, 3, 1).reshape(b, h * w, c)

    q = tokens(_conv(p["to_q"], y))
    k = tokens(_conv(p["to_k"], y))
    v = tokens(_conv(p["to_v"], y))
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    probs = torch.softmax(logits / math.sqrt(c), dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(x.dtype)
    out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
    return x + _conv(p["to_out"], out)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def vae_encode(params: Params, cfg: VAEConfig, images: torch.Tensor):
    """images [B, H, W, 3] in [-1, 1] -> (mean, logvar), each
    [B, H/ds, W/ds, latent_channels].  Span: ``edit.vae_encode``."""
    with span("edit.vae_encode"):
        p = params["encoder"]
        g = cfg.norm_groups
        x = _conv(p["conv_in"], _nchw(images))
        for i in range(len(cfg.block_channels)):
            block = p[f"down_{i}"]
            for j in range(cfg.layers_per_block):
                x = _resnet(block[f"resnet_{j}"], x, g)
            if "downsample" in block:
                # diffusers pads (0,1,0,1), VALID conv
                x = F.pad(x, (0, 1, 0, 1))
                x = _conv(block["downsample"], x, stride=2, padding=0)
        x = _resnet(p["mid"]["resnet_0"], x, g)
        x = _spatial_attn(p["mid"]["attn"], x, g)
        x = _resnet(p["mid"]["resnet_1"], x, g)
        x = silu(_group_norm(p["norm_out"], x, g))
        moments = _nhwc(_conv(p["conv_out"], x))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)


def vae_sample(mean: torch.Tensor, logvar: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
    """mean + exp(logvar / 2) * noise in float32; ``noise`` is a standard
    normal draw of mean's shape, made by the caller."""
    std = torch.exp(0.5 * logvar.float())
    return (mean.float() + std * noise.float()).to(mean.dtype)


def vae_decode(params: Params, cfg: VAEConfig,
               latents: torch.Tensor) -> torch.Tensor:
    """latents [B, h, w, C] (VAE space) -> images [B, H, W, 3], one image a
    pass: on the GPU a batched pass's convolutions do not round as one
    image's do, and an image must decode the same whatever batch it is in.
    Span: ``edit.vae_decode``."""
    with span("edit.vae_decode"):
        if latents.shape[0] == 1:
            return _decode_one(params, cfg, latents)
        return torch.cat([_decode_one(params, cfg, latents[i:i + 1])
                          for i in range(latents.shape[0])])


def _decode_one(params: Params, cfg: VAEConfig,
                latents: torch.Tensor) -> torch.Tensor:
    p = params["decoder"]
    g = cfg.norm_groups
    x = _conv(p["conv_in"], _nchw(latents))
    x = _resnet(p["mid"]["resnet_0"], x, g)
    x = _spatial_attn(p["mid"]["attn"], x, g)
    x = _resnet(p["mid"]["resnet_1"], x, g)
    for i in range(len(cfg.block_channels)):
        block = p[f"up_{i}"]
        for j in range(cfg.layers_per_block + 1):
            x = _resnet(block[f"resnet_{j}"], x, g)
        if "upsample" in block:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = _conv(block["upsample"], x)
    x = silu(_group_norm(p["norm_out"], x, g))
    return _nhwc(_conv(p["conv_out"], x))


def scale_latents(cfg: VAEConfig, latents: torch.Tensor) -> torch.Tensor:
    return (latents - cfg.shift_factor) * cfg.scaling_factor


def unscale_latents(cfg: VAEConfig, latents: torch.Tensor) -> torch.Tensor:
    return latents / cfg.scaling_factor + cfg.shift_factor
