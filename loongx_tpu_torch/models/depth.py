"""Depth-Anything depth estimator (counterpart of
``loongx_tpu/models/depth.py``).

The model behind the depth / depth_pred condition images: the reference
loads ``LiheYoung/depth-anything-small-hf`` through the Hugging Face
depth-estimation pipeline; here a local HF checkout converts through
``utils/convert.convert_depth_anything_state`` and runs on the device.

Architecture (Depth Anything = DINOv2 backbone + DPT decoder):

* DINOv2 ViT backbone: patch-14 conv embedding, [CLS] token, learned
  absolute position embeddings (bicubic-resized in float32 to grids other
  than the trained one), pre-LN blocks with per-branch layer scale,
  exact-erf GELU MLP.  Hidden states are collected after the layers named
  by ``out_indices`` and passed through the backbone's final LayerNorm.
* DPT reassemble stage: drop [CLS], tokens to an image grid, 1x1 projection
  to each stage's channels, then the stage's rescale (4x / 2x transposed
  conv, identity, or a 0.5x strided conv).
* DPT fusion stage: coarsest first, residual fusion with pre-activation
  residual conv units and align_corners=True bilinear upsampling.
* Depth head: 3 convs with a bilinear upsample to the pixel grid; ReLU for
  relative depth (sigmoid * max_depth for metric).

The params keep the JAX package's layout (HWIO conv kernels, the transposed
convs ``[cin, kh, kw, cout]``, a list of blocks), so a JAX tree bridges
straight in; the convolutions run as ``F.conv2d`` on NCHW activations, the
kernels permuted at each call.  `resize2d` is ``F.interpolate``: the JAX
package's taps were written to match it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from loongx_tpu_torch.models.vision import IMAGENET_MEAN, IMAGENET_STD
from loongx_tpu_torch.ops.nn import Params, init_layer_norm, layer_norm, normal


@dataclasses.dataclass(frozen=True)
class DepthAnythingConfig:
    # DINOv2 backbone
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    patch_size: int = 14
    image_size: int = 518  # training grid of the position embeddings
    layer_norm_eps: float = 1e-6
    out_indices: Tuple[int, ...] = (9, 10, 11, 12)  # 1-based layer numbers
    # DPT neck + head
    neck_hidden_sizes: Tuple[int, ...] = (48, 96, 192, 384)
    reassemble_factors: Tuple[float, ...] = (4.0, 2.0, 1.0, 0.5)
    fusion_hidden_size: int = 64
    head_hidden_size: int = 32
    head_in_index: int = -1
    depth_estimation_type: str = "relative"  # or "metric"
    max_depth: float = 1.0

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def from_hf_config(cfg: dict) -> "DepthAnythingConfig":
        """Build from a parsed HF ``config.json`` (DepthAnythingConfig)."""
        bb = cfg["backbone_config"]
        return DepthAnythingConfig(
            hidden_size=bb["hidden_size"],
            num_layers=bb["num_hidden_layers"],
            num_heads=bb["num_attention_heads"],
            mlp_ratio=int(bb.get("mlp_ratio", 4)),
            patch_size=bb.get("patch_size", cfg.get("patch_size", 14)),
            image_size=bb.get("image_size", 518),
            layer_norm_eps=bb.get("layer_norm_eps", 1e-6),
            out_indices=tuple(bb["out_indices"]),
            neck_hidden_sizes=tuple(cfg["neck_hidden_sizes"]),
            reassemble_factors=tuple(cfg["reassemble_factors"]),
            fusion_hidden_size=cfg["fusion_hidden_size"],
            head_hidden_size=cfg["head_hidden_size"],
            head_in_index=cfg.get("head_in_index", -1),
            depth_estimation_type=cfg.get("depth_estimation_type", "relative"),
            max_depth=cfg.get("max_depth", 1.0) or 1.0,
        )


# ---------------------------------------------------------------------------
# resampling with torch's conventions
# ---------------------------------------------------------------------------


def _resize(x: torch.Tensor, out_hw, mode: str, align_corners: bool
            ) -> torch.Tensor:
    """NCHW ``x`` resized to ``out_hw`` in float32: "linear" is bilinear,
    "cubic" bicubic (A = -0.75, border-clamped taps); no antialiasing."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[2:]) == out_hw:
        return x
    if mode not in ("linear", "cubic"):
        raise ValueError(f"unknown resize mode {mode!r}")
    y = F.interpolate(x.float(), size=out_hw,
                      mode="bilinear" if mode == "linear" else "bicubic",
                      align_corners=align_corners, antialias=False)
    return y.to(x.dtype)


def resize2d(x: torch.Tensor, out_hw: Tuple[int, int], mode: str = "linear",
             align_corners: bool = False) -> torch.Tensor:
    """Resize NHWC ``x`` to ``out_hw`` with torch interpolation semantics."""
    return _resize(x.permute(0, 3, 1, 2), out_hw, mode,
                   align_corners).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def init_depth_anything_params(cfg: DepthAnythingConfig, *, generator=None,
                               dtype=torch.float32, device="cuda") -> Params:
    """Random params in the JAX package's layout and distributions: normal
    kernels of std 0.02, zero biases, unit layer scales and norms."""
    def n(shape):
        return (normal(shape, generator=generator, device=device)
                * 0.02).to(dtype)

    def zeros(c):
        return torch.zeros(c, dtype=dtype, device=device)

    def lin(din, dout):
        return {"kernel": n((din, dout)), "bias": zeros(dout)}

    def conv(kh, cin, cout, bias=True):
        p = {"kernel": n((kh, kh, cin, cout))}
        if bias:
            p["bias"] = zeros(cout)
        return p

    def ln(c):
        return init_layer_norm(c, dtype=dtype, device=device)

    c, fh = cfg.hidden_size, cfg.fusion_hidden_size
    blocks = [{
        "ln1": ln(c), "q": lin(c, c), "k": lin(c, c), "v": lin(c, c),
        "o": lin(c, c), "ls1": torch.ones(c, dtype=dtype, device=device),
        "ln2": ln(c), "fc1": lin(c, c * cfg.mlp_ratio),
        "fc2": lin(c * cfg.mlp_ratio, c),
        "ls2": torch.ones(c, dtype=dtype, device=device),
    } for _ in range(cfg.num_layers)]

    def res_unit():
        return {"conv1": conv(3, fh, fh), "conv2": conv(3, fh, fh)}

    reassemble, convs, fusion = [], [], []
    for ch, factor in zip(cfg.neck_hidden_sizes, cfg.reassemble_factors):
        layer: Params = {"proj": conv(1, c, ch)}
        if factor > 1:
            f = int(factor)
            # transposed-conv kernel stored [cin, kh, kw, cout]
            layer["resize"] = {"kernel": n((ch, f, f, ch)), "bias": zeros(ch)}
        elif factor < 1:
            layer["resize"] = conv(3, ch, ch)
        reassemble.append(layer)
        convs.append(conv(3, ch, fh, bias=False))
        fusion.append({"proj": conv(1, fh, fh), "res1": res_unit(),
                       "res2": res_unit()})
    return {
        "cls": n((1, 1, c)),
        "pos": n((1, cfg.num_positions + 1, c)),
        "patch": conv(cfg.patch_size, 3, c),
        "blocks": blocks,
        "ln": ln(c),
        "reassemble": reassemble,
        "convs": convs,
        "fusion": fusion,
        "head": {
            "conv1": conv(3, fh, fh // 2),
            "conv2": conv(3, fh // 2, cfg.head_hidden_size),
            "conv3": conv(1, cfg.head_hidden_size, 1),
        },
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _lin(x, p):
    return x @ p["kernel"] + p["bias"]


def _conv2d(x, p, stride=1, pad=0):
    """NCHW conv with an HWIO kernel."""
    return F.conv2d(x, p["kernel"].permute(3, 2, 0, 1), p.get("bias"),
                    stride=stride, padding=pad)


def _conv_transpose_block(x, p):
    """Transposed conv with kernel_size == stride and no padding: each input
    pixel expands to a k x k block (kernel stored [cin, kh, kw, cout])."""
    w = p["kernel"]
    return F.conv_transpose2d(x, w.permute(0, 3, 1, 2), p["bias"],
                              stride=int(w.shape[1]))


def _vit_block(x, p, num_heads, eps):
    b, n, c = x.shape
    hd = c // num_heads

    h = layer_norm(x, p["ln1"]["weight"], p["ln1"]["bias"], eps)
    q, k, v = (_lin(h, p[nm]).reshape(b, n, num_heads, hd).transpose(1, 2)
               for nm in ("q", "k", "v"))
    logits = torch.matmul(q, k.transpose(-1, -2)).float()
    probs = torch.softmax(logits * (hd ** -0.5), dim=-1).to(x.dtype)
    o = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, c)
    x = x + _lin(o, p["o"]) * p["ls1"]

    h = layer_norm(x, p["ln2"]["weight"], p["ln2"]["bias"], eps)
    h = _lin(F.gelu(_lin(h, p["fc1"])), p["fc2"])
    return x + h * p["ls2"]


def _interpolated_pos(params, cfg: DepthAnythingConfig, ph, pw, square):
    pos = params["pos"]
    num_positions = pos.shape[1] - 1
    if ph * pw == num_positions and square:
        return pos
    side = int(round(num_positions ** 0.5))
    grid = pos[:, 1:].reshape(1, side, side, cfg.hidden_size)
    grid = _resize(grid.permute(0, 3, 1, 2), (ph, pw), "cubic", False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, ph * pw, cfg.hidden_size)
    return torch.cat([pos[:, :1], grid], dim=1)


def dinov2_features(params: Params, cfg: DepthAnythingConfig,
                    pixel_values: torch.Tensor) -> List[torch.Tensor]:
    """DINOv2 backbone: normalised NHWC pixels -> layer-normed hidden states
    [B, 1 + ph*pw, C] (with [CLS]) after each layer in cfg.out_indices."""
    b, h, w, _ = pixel_values.shape
    p = cfg.patch_size
    ph, pw = h // p, w // p

    x = _conv2d(pixel_values.permute(0, 3, 1, 2), params["patch"], stride=p)
    x = x.flatten(2).transpose(1, 2)  # [B, ph*pw, C]
    cls = params["cls"].to(x.dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + _interpolated_pos(params, cfg, ph, pw, square=(h == w)).to(x.dtype)

    want = set(cfg.out_indices)
    feats = []
    for i, blk in enumerate(params["blocks"]):
        x = _vit_block(x, blk, cfg.num_heads, cfg.layer_norm_eps)
        if (i + 1) in want:
            feats.append(layer_norm(x, params["ln"]["weight"],
                                    params["ln"]["bias"], cfg.layer_norm_eps))
    return feats


def _pre_act_residual(x, p):
    h = _conv2d(F.relu(x), p["conv1"], pad=1)
    h = _conv2d(F.relu(h), p["conv2"], pad=1)
    return x + h


def depth_anything_forward(params: Params, cfg: DepthAnythingConfig,
                           pixel_values: torch.Tensor) -> torch.Tensor:
    """Normalised NHWC pixels [B, H, W, 3] -> predicted depth [B, H, W]."""
    b, h, w, _ = pixel_values.shape
    p = cfg.patch_size
    ph, pw = h // p, w // p

    feats = dinov2_features(params, cfg, pixel_values)

    # reassemble: tokens -> NCHW grids at per-stage scales
    grids = []
    for feat, layer, factor in zip(feats, params["reassemble"],
                                   cfg.reassemble_factors):
        g = feat[:, 1:].transpose(1, 2).reshape(b, cfg.hidden_size, ph, pw)
        g = _conv2d(g, layer["proj"])
        if factor > 1:
            g = _conv_transpose_block(g, layer["resize"])
        elif factor < 1:
            g = _conv2d(g, layer["resize"], stride=int(round(1 / factor)),
                        pad=1)
        grids.append(g)
    grids = [_conv2d(g, cv, pad=1) for g, cv in zip(grids, params["convs"])]

    # fusion: coarsest first, upsampling into the next finer stage's grid
    rev = grids[::-1]
    fused_list = []
    fused = None
    for idx, (stage, layer) in enumerate(zip(rev, params["fusion"])):
        if fused is None:
            fused = stage
        else:
            if stage.shape != fused.shape:
                stage = _resize(stage, fused.shape[2:], "linear", False)
            fused = fused + _pre_act_residual(stage, layer["res1"])
        fused = _pre_act_residual(fused, layer["res2"])
        out_hw = (rev[idx + 1].shape[2:] if idx + 1 < len(rev)
                  else (fused.shape[2] * 2, fused.shape[3] * 2))
        fused = _resize(fused, out_hw, "linear", align_corners=True)
        fused = _conv2d(fused, layer["proj"])
        fused_list.append(fused)

    # head
    hd = params["head"]
    y = _conv2d(fused_list[cfg.head_in_index], hd["conv1"], pad=1)
    y = _resize(y, (ph * p, pw * p), "linear", align_corners=True)
    y = F.relu(_conv2d(y, hd["conv2"], pad=1))
    y = _conv2d(y, hd["conv3"])
    if cfg.depth_estimation_type == "metric":
        y = torch.sigmoid(y) * cfg.max_depth
    else:
        y = F.relu(y) * cfg.max_depth
    return y[:, 0]


# ---------------------------------------------------------------------------
# estimator wrapper: the HF pipeline's preprocessing and postprocessing
# ---------------------------------------------------------------------------


def _constrain_multiple(val: float, multiple: int, min_val: int = 0) -> int:
    """DPT sizing rule (image_processing_dpt.constrain_to_multiple_of)."""
    x = round(val / multiple) * multiple
    if x < min_val:
        x = int(np.ceil(val / multiple)) * multiple
    return int(x)


def dpt_resize_hw(in_h: int, in_w: int, target, multiple: int,
                  keep_aspect_ratio: bool = True) -> Tuple[int, int]:
    """Output (H, W) per the DPT image processor: scale as little as
    possible toward ``target`` (an int for square, or (H, W)), each dim
    rounded to ``multiple``."""
    t_h, t_w = (target, target) if isinstance(target, int) else target
    scale_h = t_h / in_h
    scale_w = t_w / in_w
    if keep_aspect_ratio:
        if abs(1 - scale_w) < abs(1 - scale_h):
            scale_h = scale_w
        else:
            scale_w = scale_h
    return (
        _constrain_multiple(scale_h * in_h, multiple, min_val=multiple),
        _constrain_multiple(scale_w * in_w, multiple, min_val=multiple),
    )


class DepthAnythingEstimator:
    """Drop-in equivalent of ``hf_pipeline("depth-estimation", ...)`` over a
    local HF checkout, the model on ``device``.

    ``__call__(pil_image)`` returns ``{"predicted_depth": np[H, W],
    "depth": PIL.Image}`` with the pipeline's min-max 0..255 formatting."""

    def __init__(
        self,
        params: Params,
        cfg: DepthAnythingConfig,
        image_mean: Optional[Sequence[float]] = None,
        image_std: Optional[Sequence[float]] = None,
        size=518,
        ensure_multiple_of: int = 14,
        keep_aspect_ratio: bool = True,
        resample: int = 3,  # PIL code: 3 = BICUBIC (the DPT default)
        do_resize: bool = True,
        do_rescale: bool = True,
        rescale_factor: float = 1.0 / 255.0,
        do_normalize: bool = True,
        device="cuda",
    ):
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device)
        self.image_mean = np.asarray(
            IMAGENET_MEAN if image_mean is None else image_mean, np.float32)
        self.image_std = np.asarray(
            IMAGENET_STD if image_std is None else image_std, np.float32)
        self.size = size
        self.ensure_multiple_of = ensure_multiple_of
        self.keep_aspect_ratio = keep_aspect_ratio
        self.resample = int(resample)
        self.do_resize = bool(do_resize)
        self.do_rescale = bool(do_rescale)
        self.rescale_factor = float(rescale_factor)
        self.do_normalize = bool(do_normalize)

    @staticmethod
    def from_pretrained(path: str, dtype=torch.float32, device="cuda"
                        ) -> "DepthAnythingEstimator":
        from loongx_tpu_torch.utils.convert import (
            convert_depth_anything_state, load_torch_or_safetensors_dir,
        )

        with open(os.path.join(path, "config.json")) as f:
            hf_cfg = json.load(f)
        cfg = DepthAnythingConfig.from_hf_config(hf_cfg)
        state = load_torch_or_safetensors_dir(path)
        params = convert_depth_anything_state(state, cfg, dtype=dtype,
                                              device=device)

        pp: Dict[str, Any] = {}
        pp_path = os.path.join(path, "preprocessor_config.json")
        if os.path.exists(pp_path):
            with open(pp_path) as f:
                pp = json.load(f)
        size = pp.get("size", {})
        if isinstance(size, dict):
            target = (size.get("height", 518), size.get("width", 518))
        elif isinstance(size, int):
            target = (size, size)
        else:
            target = (518, 518)
        return DepthAnythingEstimator(
            params,
            cfg,
            image_mean=pp.get("image_mean"),
            image_std=pp.get("image_std"),
            size=target,
            ensure_multiple_of=pp.get("ensure_multiple_of", 14),
            keep_aspect_ratio=pp.get("keep_aspect_ratio", True),
            resample=pp.get("resample", 3),
            do_resize=pp.get("do_resize", True),
            do_rescale=pp.get("do_rescale", True),
            rescale_factor=pp.get("rescale_factor", 1.0 / 255.0),
            do_normalize=pp.get("do_normalize", True),
            device=device,
        )

    @torch.inference_mode()
    def predict_depth(self, image) -> np.ndarray:
        """PIL image -> relative depth at the original resolution [H, W]."""
        rgb = image.convert("RGB")
        w0, h0 = rgb.size
        if self.do_resize:
            oh, ow = dpt_resize_hw(h0, w0, self.size, self.ensure_multiple_of,
                                   self.keep_aspect_ratio)
            rgb = rgb.resize((ow, oh), self.resample)
        x = np.asarray(rgb, np.float32)
        if self.do_rescale:
            x = x * self.rescale_factor
        if self.do_normalize:
            x = (x - self.image_mean) / self.image_std
        depth = depth_anything_forward(
            self.params, self.cfg,
            torch.from_numpy(np.ascontiguousarray(x[None])).to(self.device))
        # pipeline postprocess: torch-bicubic back to the source resolution
        depth = _resize(depth[:, None], (h0, w0), "cubic", False)[0, 0]
        return depth.cpu().numpy()

    def __call__(self, image) -> Dict[str, Any]:
        from PIL import Image

        depth = self.predict_depth(image)
        lo, hi = float(depth.min()), float(depth.max())
        norm = (depth - lo) / (hi - lo) if hi > lo else np.zeros_like(depth)
        return {
            "predicted_depth": depth,
            "depth": Image.fromarray((norm * 255).astype(np.uint8)),
        }


_ESTIMATOR_CACHE: Dict[Tuple[str, str], Any] = {}


def depth_estimator(path: Optional[str] = None, device="cuda"):
    """The depth-estimation callable of the depth / depth_pred condition
    synthesis: ``est(pil)["depth"]`` -> PIL depth map.

    A local HF checkout directory runs `DepthAnythingEstimator` on
    ``device``; a hub id falls back to the HF pipeline (the reference's
    behaviour; it needs the network or a cached download).  The default
    path comes from $LOONGX_DEPTH_MODEL.  Cached per (path, device)."""
    path = path or os.environ.get(
        "LOONGX_DEPTH_MODEL", "LiheYoung/depth-anything-small-hf")
    key = (path, str(torch.device(device)))
    if key in _ESTIMATOR_CACHE:
        return _ESTIMATOR_CACHE[key]
    if os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json")):
        est: Any = DepthAnythingEstimator.from_pretrained(path, device=device)
    else:
        est = _hf_depth_pipeline(path, device)
    _ESTIMATOR_CACHE[key] = est
    return est


def _hf_depth_pipeline(model: str, device):
    """The Hugging Face depth-estimation pipeline of a hub id on
    ``device``."""
    from transformers import pipeline as hf_pipeline

    return hf_pipeline(task="depth-estimation", model=model, device=device)
