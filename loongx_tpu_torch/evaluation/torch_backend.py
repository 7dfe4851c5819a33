"""In-framework CLIP and DINO backends for the eval harness (counterpart of
``loongx_tpu/evaluation/jax_backend.py``).

The CLIP text + vision towers and the DINO ViT of this package on the
device, in place of the Hugging Face models the reference's eval loads.
Build from a converted bundle (``cli/convert --eval_clip``; its numpy
leaves are bridged onto ``device``) or pass param trees directly.  Images
are read by Pillow and resized to the tower's ``image_size`` on the host,
in batches of ``batch_size``, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from loongx_tpu_torch.models.text.clip import CLIPTextConfig, clip_text_features
from loongx_tpu_torch.models.text.clip_vision import (
    CLIPVisionConfig, clip_preprocess, clip_vision_encode,
)
from loongx_tpu_torch.models.vision import ViTConfig, vit_encode, vit_preprocess
from loongx_tpu_torch.utils.bridge import from_numpy_tree


def _image_batches(paths: Sequence[str], size: int, batch_size: int):
    """float32 [n, size, size, 3] in [0, 1], ``batch_size`` paths at a
    time, read and resized by Pillow."""
    from PIL import Image

    for start in range(0, len(paths), batch_size):
        yield np.stack([
            np.asarray(Image.open(p).convert("RGB").resize((size, size)),
                       np.float32) / 255.0
            for p in paths[start:start + batch_size]])


def _embedder(fn, size: int, batch_size: int, device) -> Callable:
    @torch.inference_mode()
    def image_embed(paths: Sequence[str]) -> np.ndarray:
        return np.concatenate([
            fn(torch.from_numpy(imgs).to(device)).cpu().numpy()
            for imgs in _image_batches(list(paths), size, batch_size)])

    return image_embed


def make_clip_backend(
    text_params,
    text_cfg: CLIPTextConfig,
    vision_params,
    vision_cfg: CLIPVisionConfig,
    tokenizer,
    batch_size: int = 16,
    device="cuda",
) -> Tuple[Callable, Callable]:
    """Returns (image_embed(paths) -> [N, D], text_embed(texts) -> [N, D]),
    the towers on ``device``."""
    text_params = from_numpy_tree(text_params, device)
    vision_params = from_numpy_tree(vision_params, device)

    def image_fn(images):
        return clip_vision_encode(
            vision_params, vision_cfg,
            clip_preprocess(images, vision_cfg.image_size))

    @torch.inference_mode()
    def text_embed(texts: Sequence[str]) -> np.ndarray:
        ids = tokenizer(
            list(texts), padding="max_length",
            max_length=min(77, text_cfg.max_positions), truncation=True,
            return_tensors="np",
        ).input_ids
        return clip_text_features(
            text_params, text_cfg, torch.from_numpy(np.asarray(ids)).to(device)
        ).cpu().numpy()

    return (_embedder(image_fn, vision_cfg.image_size, batch_size, device),
            text_embed)


def make_dino_backend(vit_params, vit_cfg: ViTConfig, batch_size: int = 16,
                      device="cuda") -> Callable:
    """DINO CLS-feature image embedder from a converted HF ViT checkpoint
    (utils/convert.convert_vit_state), on ``device``."""
    vit_params = from_numpy_tree(vit_params, device)

    def image_fn(images):
        return vit_encode(vit_params, vit_cfg,
                          vit_preprocess(images, vit_cfg.image_size))

    return _embedder(image_fn, vit_cfg.image_size, batch_size, device)
