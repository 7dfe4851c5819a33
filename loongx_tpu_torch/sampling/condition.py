"""Conditions attached to a generation call: spatial control, subject and
the SEED biosignal edit (counterpart of ``loongx_tpu/sampling/condition.py``).

A condition type maps to an integer type id; the condition image is
synthesised on the host (canny, grayscale, blur, resample; PIL and cv2 are
imported inside `synthesize_condition_image`, as in JAX) or by the
Depth-Anything estimator on a device, and encoded by the
pipeline's VAE into latent tokens with RoPE ids shifted by position_delta /
position_scale.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from loongx_tpu_torch.ops.latents import latent_image_ids, shift_ids

# The reference's condition_dict.
CONDITION_TYPE_IDS = {
    "depth": 0,
    "canny": 1,
    "subject": 4,
    "coloring": 6,
    "deblurring": 7,
    "depth_pred": 8,
    "fill": 9,
    "sr": 10,
    "cartoon": 11,
    "eeg+fnirs": 12,
}

# Types with a latent encoding; SEED editing ("eeg+fnirs") encodes the
# source image like any condition image, the biosignals ride separately.
_IMAGE_CONDITION_TYPES = (
    "depth", "canny", "subject", "coloring", "deblurring", "depth_pred",
    "fill", "sr", "cartoon", "eeg+fnirs",
)


def _to_numpy_image(img) -> np.ndarray:
    """PIL.Image | array [H, W, 3] (uint8 or float) -> float32 [-1, 1]."""
    if hasattr(img, "convert"):
        img = np.asarray(img.convert("RGB"))
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 127.5 - 1.0
    return img.astype(np.float32)


def synthesize_condition_image(condition_type: str, raw_img,
                               device="cuda") -> Any:
    """The condition image synthesised from a raw PIL image: on the host,
    but for depth / depth_pred, whose Depth-Anything estimator
    (``models/depth.depth_estimator``: the local checkout at
    $LOONGX_DEPTH_MODEL, else the HF pipeline) runs on ``device``."""
    from PIL import Image, ImageFilter

    if condition_type == "canny":
        import cv2

        edges = cv2.Canny(np.asarray(raw_img.convert("RGB")), 100, 200)
        return Image.fromarray(edges).convert("RGB")
    if condition_type == "coloring":
        return raw_img.convert("L").convert("RGB")
    if condition_type == "deblurring":
        return raw_img.convert("RGB").filter(ImageFilter.GaussianBlur(10))
    if condition_type == "sr":
        w, h = raw_img.size
        return raw_img.resize((w // 4, h // 4)).resize((w, h))
    if condition_type in ("subject", "fill", "cartoon"):
        return raw_img.convert("RGB")
    if condition_type in ("depth", "depth_pred"):
        import os

        from loongx_tpu_torch.models.depth import depth_estimator

        try:
            est = depth_estimator(device=device)
        except Exception as exc:  # no weights in zero-egress envs
            hint = (
                "failed to load the depth-estimation model from "
                f"$LOONGX_DEPTH_MODEL={os.environ['LOONGX_DEPTH_MODEL']!r} "
                "(unsupported variant or malformed checkpoint? see chained "
                "cause)"
                if os.environ.get("LOONGX_DEPTH_MODEL")
                else "depth condition requires a local depth-estimation "
                "model (point $LOONGX_DEPTH_MODEL at an HF checkout of "
                "depth-anything)"
            )
            raise RuntimeError(hint) from exc
        return est(raw_img.convert("RGB"))["depth"].convert("RGB")
    return raw_img


@dataclasses.dataclass
class Condition:
    """One condition of a generation call: ``raw_img`` (the condition image
    is synthesised from it, a depth estimate on ``device``) or
    ``condition`` (a precomputed condition image or array); biosignals ride
    along as raw arrays."""

    condition_type: str
    raw_img: Any = None
    condition: Any = None
    position_delta: Optional[Tuple[int, int]] = None
    position_scale: float = 1.0
    eeg: Optional[np.ndarray] = None
    fnirs: Optional[np.ndarray] = None
    ppg: Optional[np.ndarray] = None
    motion: Optional[np.ndarray] = None
    device: Any = "cuda"

    def __post_init__(self):
        if self.condition_type not in CONDITION_TYPE_IDS:
            raise ValueError(
                f"unknown condition type {self.condition_type!r}; "
                f"known: {sorted(CONDITION_TYPE_IDS)}")
        if self.condition is None and self.raw_img is not None:
            self.condition = synthesize_condition_image(
                self.condition_type, self.raw_img, self.device)

    @property
    def type_id(self) -> int:
        return CONDITION_TYPE_IDS[self.condition_type]

    @staticmethod
    def get_type_id(condition_type: str) -> int:
        return CONDITION_TYPE_IDS[condition_type]

    def encode(self, pipeline, noise: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The condition image -> (tokens [1, S, 4C], ids [S, 3], type_ids
        [S, 1]) through the pipeline's VAE on its device.  ``noise`` (a
        standard-normal draw of the latent's shape) samples the latent
        distribution; without it the mean is used.  Subject conditions sit
        beside the canvas by default (position delta (0, -W/16))."""
        if self.condition_type not in _IMAGE_CONDITION_TYPES:
            raise NotImplementedError(
                f"condition type {self.condition_type!r} has no latent encoding")
        img = _to_numpy_image(self.condition)[None]  # [1, H, W, 3]
        device = pipeline.device
        tokens, h, w = pipeline.encode_image_tokens(
            torch.as_tensor(img, device=device), noise=noise)
        ids = latent_image_ids(h, w, device=device)
        delta = self.position_delta
        if delta is None and self.condition_type == "subject":
            delta = (0, -img.shape[2] // 16)
        ids = shift_ids(ids, delta or (0, 0), self.position_scale)
        type_ids = torch.full((ids.shape[0], 1), float(self.type_id),
                              dtype=torch.float32, device=device)
        return tokens, ids, type_ids
