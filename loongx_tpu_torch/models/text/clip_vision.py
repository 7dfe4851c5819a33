"""CLIP vision tower (ViT), the image half of CLIP-I / CLIP-T (counterpart
of ``loongx_tpu/models/text/clip_vision.py``).

With the text tower in ``clip.py`` and the two projection heads, the whole
metric stack runs on the device in this package; Hugging Face checkpoints
convert through ``utils/convert.convert_clip_vision_state``.

ViT-B/32 geometry by default (the reference's eval model): 224 px, 32 px
patches, 12 layers, hidden 768, projection 512.  The pre-LN block loop
(`encoder_blocks`) is shared with the DINO ViT of ``models/vision.py``; it
runs over the stacked ``[NB, ...]`` block tree one block at a time, where
the JAX package scans it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from loongx_tpu_torch.models.text.clip import _affine, _init_block, quick_gelu
from loongx_tpu_torch.ops.nn import (
    Params, init_layer_norm, init_linear, layer_norm, normal, qdot,
    stack_trees,
)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden: int = 768
    num_layers: int = 12
    num_heads: int = 12
    d_ff: int = 3072
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def b32() -> "CLIPVisionConfig":
        return CLIPVisionConfig()

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(
            image_size=16, patch_size=8, hidden=32, num_layers=2, num_heads=4,
            d_ff=64, projection_dim=16,
        )


def init_clip_vision_params(cfg: CLIPVisionConfig, *, generator=None,
                            dtype=torch.float32, device="cuda") -> Params:
    """Random params in the JAX package's layout and distributions."""
    kw = dict(generator=generator, dtype=dtype, device=device)

    def n(shape):
        return (normal(shape, generator=generator, device=device)
                * 0.02).to(dtype)

    blocks = stack_trees([_init_block(cfg, **kw)
                          for _ in range(cfg.num_layers)])
    return {
        # the patch conv as a linear over flattened (y, x, c) patches
        "patch_embed": {"kernel": n((cfg.patch_size * cfg.patch_size * 3,
                                    cfg.hidden))},
        "class_embed": n((cfg.hidden,)),
        "pos_embed": n((cfg.num_patches + 1, cfg.hidden)),
        "pre_ln": init_layer_norm(cfg.hidden, dtype=dtype, device=device),
        "blocks": blocks,
        "post_ln": init_layer_norm(cfg.hidden, dtype=dtype, device=device),
        "projection": init_linear(cfg.hidden, cfg.projection_dim, bias=False,
                                  **kw),
    }


def _patches(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, patch*patch*C] (row-major patches, (y, x, c)
    order inside each patch: a torch Conv2d(stride=patch) after the kernel
    transpose in utils/convert)."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, gh, gw, p, p, C]
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * c)


def encoder_blocks(x: torch.Tensor, blocks: Params, num_heads: int,
                   eps: float, act: Callable[[torch.Tensor], torch.Tensor]
                   ) -> torch.Tensor:
    """The pre-LN blocks of a ViT over ``x`` [B, S, H]: attention with
    float32 logits and probabilities, then ``act`` between fc1 and fc2."""
    b, s, _ = x.shape
    scale = 1.0 / torch.sqrt(torch.tensor(float(x.shape[-1] // num_heads)))

    def heads(t):
        return t.reshape(b, s, num_heads, -1).transpose(1, 2)

    for i in range(blocks["ln1"]["weight"].shape[0]):
        blk = {name: {k: v[i] for k, v in leaf.items()}
               for name, leaf in blocks.items()}
        h = layer_norm(x, blk["ln1"]["weight"], blk["ln1"]["bias"], eps)
        q, k, v = (heads(_affine(blk[nm], h)) for nm in ("q", "k", "v"))
        logits = (torch.matmul(q.float(), k.float().transpose(-1, -2))
                  * scale.to(x.device))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.matmul(probs.float(), v.float()).to(x.dtype)
        x = x + _affine(blk["o"], attn.transpose(1, 2).reshape(b, s, -1))
        h = layer_norm(x, blk["ln2"]["weight"], blk["ln2"]["bias"], eps)
        x = x + _affine(blk["fc2"], act(_affine(blk["fc1"], h)))
    return x


def clip_vision_encode(params: Params, cfg: CLIPVisionConfig,
                       images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (CLIP-normalised) -> projected embeddings
    [B, projection_dim] (the ``get_image_features`` output), float32."""
    b = images.shape[0]
    x = qdot(params["patch_embed"], _patches(images, cfg.patch_size)).to(
        images.dtype)
    cls = params["class_embed"].to(x.dtype).expand(b, 1, cfg.hidden)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"][: x.shape[1]]
    x = layer_norm(x, params["pre_ln"]["weight"], params["pre_ln"]["bias"],
                   cfg.layer_norm_eps)
    x = encoder_blocks(x, params["blocks"], cfg.num_heads,
                       cfg.layer_norm_eps, quick_gelu)
    pooled = layer_norm(x[:, 0], params["post_ln"]["weight"],
                        params["post_ln"]["bias"], cfg.layer_norm_eps)
    return qdot(params["projection"], pooled)


# CLIP image-preprocessing constants (OpenAI)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, size, size, C]: bilinear with half-pixel centres,
    antialiased when it shrinks (``jax.image.resize(..., "bilinear")``'s
    triangle filter; see tests/test_torch_eval.py for how close)."""
    x = images.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).to(images.dtype)


def normalize(images: torch.Tensor, size: int, mean, std) -> torch.Tensor:
    """Resize to ``size`` (when it differs) and normalise per channel."""
    if tuple(images.shape[1:3]) != (size, size):
        images = resize_bilinear(images, size)
    mean = torch.tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def clip_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] float [0, 1] -> CLIP-normalised [B, size, size, 3]."""
    return normalize(images, size, CLIP_MEAN, CLIP_STD)
