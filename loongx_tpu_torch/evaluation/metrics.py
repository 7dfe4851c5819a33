"""Evaluation harness: L1/L2, CLIP-I, DINO, CLIP-T over generated-vs-GT
pairs (counterpart of ``loongx_tpu/evaluation/metrics.py``).

The reference's ``test.py`` equivalent: pairs generated/ground-truth images
by the ``_0`` -> ``_1`` filename rule, computes pixel distances and
embedding cosines, writes ``evaluation_metrics.txt`` +
``per_image_metrics.csv``.

Embedding backends are injectable callables (paths or texts -> [N, D]
features), so the math is testable without downloaded weights: this
package's own towers (``evaluation/torch_backend.py``) or the default
backends, which load Hugging Face CLIP / DINO from a local path onto
``device``.
"""

from __future__ import annotations

import csv
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Pairing (reference test.py:241-250)
# ---------------------------------------------------------------------------


def pair_generated_gt(
    gen_dir: str, gt_dir: Optional[str] = None,
    gen_suffix: str = "_0", gt_suffix: str = "_1",
    exts: Sequence[str] = (".png", ".jpg", ".jpeg"),
) -> List[Tuple[str, str]]:
    """Match generated files named ``*_0.*`` with ground truth ``*_1.*``."""
    gt_dir = gt_dir or gen_dir
    gt_index = {}
    for f in os.listdir(gt_dir):
        stem, ext = os.path.splitext(f)
        if ext.lower() in exts and stem.endswith(gt_suffix):
            gt_index[stem[: -len(gt_suffix)]] = os.path.join(gt_dir, f)
    pairs = []
    for f in sorted(os.listdir(gen_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() in exts and stem.endswith(gen_suffix):
            key = stem[: -len(gen_suffix)]
            if key in gt_index:
                pairs.append((os.path.join(gen_dir, f), gt_index[key]))
    return pairs


# ---------------------------------------------------------------------------
# Pixel metrics (reference eval_distance, test.py:17-44)
# ---------------------------------------------------------------------------


def _load_unit_image(path: str, size: int = 512) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size))
    return np.asarray(img, np.float32) / 255.0


def eval_distance(pairs: List[Tuple[str, str]], metric: str = "l1",
                  size: int = 512) -> float:
    """Mean per-pixel L1 (MAE) or L2 (MSE) over the pair list."""
    vals = []
    for gen, gt in pairs:
        a = _load_unit_image(gen, size)
        b = _load_unit_image(gt, size)
        if metric == "l1":
            vals.append(float(np.mean(np.abs(a - b))))
        elif metric == "l2":
            vals.append(float(np.mean((a - b) ** 2)))
        else:
            raise ValueError(f"unknown metric {metric!r}")
    return float(np.mean(vals)) if vals else float("nan")


# ---------------------------------------------------------------------------
# Embedding cosine metrics
# ---------------------------------------------------------------------------


def cosine_matrix_mean(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise cosine similarity between paired feature matrices [N, D]."""
    a = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
    b = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-12)
    return np.sum(a * b, axis=1)


def _default_clip_backend(model_path: str, device="cuda"):
    """(image_embed, text_embed) callables from a local HF CLIP checkpoint,
    the model on ``device``."""
    import torch
    from PIL import Image
    from transformers import CLIPModel, CLIPProcessor

    model = CLIPModel.from_pretrained(model_path).to(device).eval()
    proc = CLIPProcessor.from_pretrained(model_path)

    @torch.no_grad()
    def image_embed(paths: Sequence[str]) -> np.ndarray:
        imgs = [Image.open(p).convert("RGB") for p in paths]
        inputs = proc(images=imgs, return_tensors="pt").to(device)
        return model.get_image_features(**inputs).cpu().numpy()

    @torch.no_grad()
    def text_embed(texts: Sequence[str]) -> np.ndarray:
        inputs = proc(text=list(texts), return_tensors="pt", padding=True,
                      truncation=True).to(device)
        return model.get_text_features(**inputs).cpu().numpy()

    return image_embed, text_embed


def _default_dino_backend(model_path: str, device="cuda"):
    """CLS-feature image embedder from a local HF DINO checkpoint, the model
    on ``device``."""
    import torch
    from PIL import Image
    from transformers import AutoImageProcessor, AutoModel

    model = AutoModel.from_pretrained(model_path).to(device).eval()
    proc = AutoImageProcessor.from_pretrained(model_path)

    @torch.no_grad()
    def image_embed(paths: Sequence[str]) -> np.ndarray:
        imgs = [Image.open(p).convert("RGB") for p in paths]
        inputs = proc(images=imgs, return_tensors="pt").to(device)
        out = model(**inputs).last_hidden_state[:, 0]  # CLS token
        return out.cpu().numpy()

    return image_embed


def evaluate_directory(
    gen_dir: str,
    gt_dir: Optional[str] = None,
    instructions: Optional[Dict[str, str]] = None,
    clip_image_embed: Optional[Callable] = None,
    clip_text_embed: Optional[Callable] = None,
    dino_image_embed: Optional[Callable] = None,
    clip_path: Optional[str] = None,
    dino_path: Optional[str] = None,
    out_dir: Optional[str] = None,
    image_size: int = 512,
    device="cuda",
) -> Dict[str, float]:
    """Full evaluation run; writes evaluation_metrics.txt +
    per_image_metrics.csv when out_dir is set (reference test.py:321-336).

    instructions: optional {pair_key: instruction text} for CLIP-T.
    ``clip_path`` / ``dino_path`` load the Hugging Face backends onto
    ``device``.
    """
    pairs = pair_generated_gt(gen_dir, gt_dir)
    if not pairs:
        raise ValueError(f"no generated/gt pairs found in {gen_dir}")

    if clip_image_embed is None and clip_path:
        clip_image_embed, clip_text_embed = _default_clip_backend(
            clip_path, device)
    if dino_image_embed is None and dino_path:
        dino_image_embed = _default_dino_backend(dino_path, device)

    results: Dict[str, float] = {
        "l1": eval_distance(pairs, "l1", image_size),
        "l2": eval_distance(pairs, "l2", image_size),
        "num_pairs": float(len(pairs)),
    }
    per_image: Dict[str, Dict[str, float]] = {
        os.path.basename(g): {} for g, _ in pairs
    }

    gen_paths = [g for g, _ in pairs]
    gt_paths = [t for _, t in pairs]

    if clip_image_embed is not None:
        fg = clip_image_embed(gen_paths)
        ft = clip_image_embed(gt_paths)
        sims = cosine_matrix_mean(fg, ft)
        results["clip_i"] = float(np.mean(sims))
        for (g, _), s in zip(pairs, sims):
            per_image[os.path.basename(g)]["clip_i"] = float(s)

        if clip_text_embed is not None and instructions:
            keys = [
                os.path.splitext(os.path.basename(g))[0].removesuffix("_0")
                for g, _ in pairs
            ]
            texts = [instructions.get(k, "") for k in keys]
            te = clip_text_embed(texts)
            sims_gen = cosine_matrix_mean(fg, te)
            sims_gt = cosine_matrix_mean(ft, te)
            results["clip_t_gen"] = float(np.mean(sims_gen))
            results["clip_t_gt"] = float(np.mean(sims_gt))
            for (g, _), s in zip(pairs, sims_gen):
                per_image[os.path.basename(g)]["clip_t"] = float(s)

    if dino_image_embed is not None:
        dg = dino_image_embed(gen_paths)
        dt = dino_image_embed(gt_paths)
        sims = cosine_matrix_mean(dg, dt)
        results["dino_i"] = float(np.mean(sims))
        for (g, _), s in zip(pairs, sims):
            per_image[os.path.basename(g)]["dino_i"] = float(s)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "evaluation_metrics.txt"), "w") as f:
            for k, v in results.items():
                f.write(f"{k}: {v:.6f}\n")
        cols = sorted({c for row in per_image.values() for c in row})
        with open(os.path.join(out_dir, "per_image_metrics.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["image"] + cols)
            for name, row in sorted(per_image.items()):
                w.writerow([name] + [row.get(c, "") for c in cols])
    return results
