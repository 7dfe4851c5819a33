"""Generic pre-LN ViT encoder, DINO-style (counterpart of
``loongx_tpu/models/vision.py``).

The reference's DINO-I metric takes the CLS features of ``dino_vits16``;
this tower with ``utils/convert.convert_vit_state`` runs the same ViT-S/16
on the device.  Standard ViT: patch conv, CLS token, learned positions,
pre-LN blocks with exact-GELU MLPs, a final LayerNorm; the DINO feature is
the final CLS state.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from loongx_tpu_torch.models.text.clip import _init_block
from loongx_tpu_torch.models.text.clip_vision import (
    _patches, encoder_blocks, normalize,
)
from loongx_tpu_torch.ops.nn import (
    Params, init_layer_norm, init_linear, layer_norm, linear, normal,
    stack_trees,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden: int = 384
    num_layers: int = 12
    num_heads: int = 6
    d_ff: int = 1536
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def dino_s16() -> "ViTConfig":
        return ViTConfig()

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(image_size=16, patch_size=8, hidden=32, num_layers=2,
                         num_heads=4, d_ff=64)


def init_vit_params(cfg: ViTConfig, *, generator=None, dtype=torch.float32,
                    device="cuda") -> Params:
    """Random params in the JAX package's layout and distributions."""
    kw = dict(generator=generator, dtype=dtype, device=device)

    def n(shape):
        return (normal(shape, generator=generator, device=device)
                * 0.02).to(dtype)

    blocks = stack_trees([_init_block(cfg, **kw)
                          for _ in range(cfg.num_layers)])
    return {
        "patch_embed": init_linear(cfg.patch_size * cfg.patch_size * 3,
                                   cfg.hidden, **kw),
        "cls_token": n((cfg.hidden,)),
        "pos_embed": n((cfg.num_patches + 1, cfg.hidden)),
        "blocks": blocks,
        "final_ln": init_layer_norm(cfg.hidden, dtype=dtype, device=device),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact erf


def vit_encode(params: Params, cfg: ViTConfig, images: torch.Tensor
               ) -> torch.Tensor:
    """images [B, H, W, 3] (normalised) -> CLS features [B, hidden],
    float32."""
    b = images.shape[0]
    x = linear(params["patch_embed"], _patches(images, cfg.patch_size))
    cls = params["cls_token"].to(x.dtype).expand(b, 1, cfg.hidden)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"][: x.shape[1]]
    x = encoder_blocks(x, params["blocks"], cfg.num_heads, cfg.layer_norm_eps,
                       _gelu)
    x = layer_norm(x, params["final_ln"]["weight"], params["final_ln"]["bias"],
                   cfg.layer_norm_eps)
    return x[:, 0].float()


# ImageNet normalisation (what Hugging Face's DINO processor applies)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vit_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] float [0, 1] -> ImageNet-normalised [B, size, size, 3]."""
    return normalize(images, size, IMAGENET_MEAN, IMAGENET_STD)
