"""Datasets: the L-Mind biosignal editing corpus and spatial-control
synthesis (counterpart of ``loongx_tpu/data/datasets.py``, its own copy).

numpy, PIL and cv2 on the host, samples as plain dicts of numpy arrays,
a numpy RNG seeded per index (reproducible whatever the worker
scheduling), images through this package's host ops (`native`): every
sample equals the JAX package's bit for bit.

Sample contract (matching the reference's consumers):
  image      float32 [H, W, 3] in [0, 1]   (the x0 / denoise target)
  condition  float32 [H, W, 3] in [0, 1]   (condition image)
  description  str
  condition_type  str
  position_delta  int array [2]
  position_scale  float (only when != 1)
  eeg/fnirs/ppg/motion  float32 [C, L] (SeedDataset only; None when absent)
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from loongx_tpu_torch import native


def _img_to_float(img, size: Optional[int] = None) -> np.ndarray:
    """PIL -> float32 [H, W, 3] in [0, 1] (ToTensor equivalent, NHWC).

    Hot path goes through the native host-ops library (bilinear resize +
    u8->f32 in one pass, GIL-free so the loader's thread pool scales)."""
    arr = np.asarray(img.convert("RGB"), np.uint8)
    if size is not None and arr.shape[:2] != (size, size):
        return native.resize_bilinear(arr, size, size)
    return native.u8_to_f32(arr)


class SeedDataset:
    """L-Mind neural-editing corpus: jsonl rows joined against a pickled
    biosignal dict keyed by source-image filename
    (reference data.py:11-98).  Keeps the reference's pairing: ``image`` is
    the source frame, ``condition`` the edited target frame, description
    prefers the speech transcript."""

    def __init__(
        self,
        jsonl_path: str,
        condition_size: int = 512,
        condition_type: str = "subject",
        image_dir: str = "",
        pkl_path: Optional[str] = None,
        image_size: int = 512,
    ):
        self.image_dir = image_dir
        self.condition_type = condition_type
        self.condition_size = condition_size
        self.image_size = image_size

        pkl_path = pkl_path or os.path.join(
            os.path.dirname(jsonl_path), "data_final.pkl"
        )
        with open(pkl_path, "rb") as f:
            self.bio_data = pickle.load(f)

        self.samples: List[dict] = []
        with open(jsonl_path, "r", encoding="utf-8") as f:
            for line in f:
                row = json.loads(line)
                if row["source_image"].split("/")[-1] in self.bio_data:
                    self.samples.append(row)

    def __len__(self):
        return len(self.samples)

    def descriptions(self) -> List[str]:
        """Every description string this dataset can emit — cheap (no image
        decode).  Consumed by the staged-text train path (train/loop.py) to
        pre-encode all prompts before the text encoders are freed."""
        return [
            item.get("speech2text") or item.get("instruction", "")
            for item in self.samples
        ]

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from PIL import Image

        item = self.samples[idx]
        source = Image.open(
            os.path.join(self.image_dir, item["source_image"])
        )
        target = Image.open(
            os.path.join(self.image_dir, item["target_image"])
        )
        bio = self.bio_data[item["source_image"].split("/")[-1]]

        def sig(name):
            v = bio.get(name)
            return None if v is None else np.asarray(v, np.float32)

        return {
            "image": _img_to_float(source, self.image_size),
            "condition": _img_to_float(target, self.image_size),
            "description": item.get("speech2text") or item.get("instruction", ""),
            "condition_type": self.condition_type,
            "position_delta": np.array([0, -self.condition_size // 16]),
            "eeg": sig("EEG"),
            "fnirs": sig("FNIRS"),
            "ppg": sig("PPG"),
            "motion": sig("Motion"),
        }


class SubjectPairDataset:
    """Subject-driven pairs: each base item holds a side-by-side image whose
    left/right halves alternate as target/condition
    (reference Subject200KDataset, data.py:101-189)."""

    def __init__(
        self,
        base_dataset,
        condition_size: int = 512,
        target_size: int = 512,
        image_size: int = 512,
        padding: int = 0,
        condition_type: str = "subject",
        drop_text_prob: float = 0.1,
        drop_image_prob: float = 0.1,
        seed: int = 0,
    ):
        self.base = base_dataset
        self.condition_size = condition_size
        self.target_size = target_size
        self.image_size = image_size
        self.padding = padding
        self.condition_type = condition_type
        self.drop_text_prob = drop_text_prob
        self.drop_image_prob = drop_image_prob
        self.seed = seed

    def __len__(self):
        return len(self.base) * 2

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        rng = np.random.default_rng((self.seed, idx))
        target_side = idx % 2
        item = self.base[idx // 2]
        image = item["image"]
        p, s = self.padding, self.image_size
        left = image.crop((p, p, s + p, s + p))
        right = image.crop((s + 2 * p, p, 2 * s + 2 * p, s + p))
        target_img, cond_img = (
            (left, right) if target_side == 0 else (right, left)
        )
        description = item["description"][
            "description_0" if target_side == 0 else "description_1"
        ]
        if rng.random() < self.drop_text_prob:
            description = ""
        cond = (
            np.zeros((self.condition_size, self.condition_size, 3), np.float32)
            if rng.random() < self.drop_image_prob
            else _img_to_float(cond_img, self.condition_size)
        )
        return {
            "image": _img_to_float(target_img, self.target_size),
            "condition": cond,
            "condition_type": self.condition_type,
            "description": description,
            "position_delta": np.array([0, -self.condition_size // 16]),
        }


class ImageConditionDataset:
    """Text-to-image corpus with on-the-fly spatial-control synthesis:
    canny / coloring / deblurring / depth / depth_pred / fill / sr
    (reference ImageConditionDataset, data.py:192-320)."""

    def __init__(
        self,
        base_dataset,
        condition_size: int = 512,
        target_size: int = 512,
        condition_type: str = "canny",
        drop_text_prob: float = 0.1,
        drop_image_prob: float = 0.1,
        position_scale: float = 1.0,
        seed: int = 0,
        depth_fn: Optional[Callable] = None,
        device="cuda",
    ):
        self.base = base_dataset
        self.condition_size = condition_size
        self.target_size = target_size
        self.condition_type = condition_type
        self.drop_text_prob = drop_text_prob
        self.drop_image_prob = drop_image_prob
        self.position_scale = position_scale
        self.seed = seed
        self._depth_fn = depth_fn
        self.device = device

    def __len__(self):
        return len(self.base)

    @property
    def depth_fn(self):
        """The depth map of a PIL image: ``depth_fn`` when given, else the
        Depth-Anything estimator (``models/depth.depth_estimator``) on
        ``device``, the training device."""
        if self._depth_fn is None:
            from loongx_tpu_torch.models.depth import depth_estimator

            est = depth_estimator(device=self.device)
            self._depth_fn = lambda img: est(img)["depth"]
        return self._depth_fn

    def _canny(self, img):
        import cv2
        from PIL import Image

        ratio = self.condition_size / max(img.size)
        img = img.resize(
            (int(img.size[0] * ratio), int(img.size[1] * ratio))
        )
        gray = cv2.cvtColor(np.asarray(img), cv2.COLOR_RGB2GRAY)
        return Image.fromarray(cv2.Canny(gray, 100, 200)).convert("RGB")

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from PIL import Image, ImageDraw, ImageFilter

        rng = np.random.default_rng((self.seed, idx))
        item = self.base[idx]
        image = item["jpg"].resize(
            (self.target_size, self.target_size)
        ).convert("RGB")
        description = item["json"]["prompt"]
        csize = self.condition_size
        position_scale = self.position_scale
        position_delta = np.array([0, 0])
        ct = self.condition_type

        if ct == "canny":
            cond_img = self._canny(image)
        elif ct == "coloring":
            cond_img = image.resize((csize, csize)).convert("L").convert("RGB")
        elif ct == "deblurring":
            radius = int(rng.integers(1, 11))
            cond_img = (
                image.filter(ImageFilter.GaussianBlur(radius))
                .resize((csize, csize)).convert("RGB")
            )
        elif ct == "depth":
            cond_img = self.depth_fn(image).convert("RGB").resize((csize, csize))
        elif ct == "depth_pred":
            cond_img = image
            image = self.depth_fn(cond_img).convert("RGB")
            description = f"[depth] {description}"
        elif ct == "fill":
            w, h = image.size
            x1, x2 = sorted(rng.integers(0, w + 1, 2).tolist())
            y1, y2 = sorted(rng.integers(0, h + 1, 2).tolist())
            mask = Image.new("L", image.size, 0)
            ImageDraw.Draw(mask).rectangle([x1, y1, x2, y2], fill=255)
            if rng.random() > 0.5:
                mask = Image.eval(mask, lambda a: 255 - a)
            cond_img = Image.composite(
                image, Image.new("RGB", image.size, (0, 0, 0)), mask
            )
        elif ct == "sr":
            cond_img = image.resize((csize, csize)).convert("RGB")
            position_delta = np.array([0, -csize // 16])
        else:
            raise ValueError(f"condition type {ct!r} not implemented")

        if rng.random() < self.drop_text_prob:
            description = ""
        if rng.random() < self.drop_image_prob:
            cond = np.zeros((csize, csize, 3), np.float32)
        else:
            cond = _img_to_float(cond_img, csize if ct != "depth_pred" else None)

        out = {
            "image": _img_to_float(image, self.target_size),
            "condition": cond,
            "condition_type": ct,
            "description": description,
            "position_delta": position_delta,
        }
        if position_scale != 1.0:
            out["position_scale"] = position_scale
        return out


class CartoonDataset:
    """Cartoon character pairs (reference CartoonDataset, data.py:323-415)."""

    TAG_PHRASES = {
        "lion": "lion like animal", "bear": "bear like animal",
        "gorilla": "gorilla like animal", "dog": "dog like animal",
        "elephant": "elephant like animal", "eagle": "eagle like bird",
        "tiger": "tiger like animal", "owl": "owl like bird",
        "woman": "woman", "parrot": "parrot like bird",
        "mouse": "mouse like animal", "man": "man",
        "pigeon": "pigeon like bird", "girl": "girl",
        "panda": "panda like animal", "crocodile": "crocodile like animal",
        "rabbit": "rabbit like animal", "boy": "boy",
        "monkey": "monkey like animal", "cat": "cat like animal",
    }

    def __init__(
        self,
        base_dataset,
        condition_size: int = 1024,
        target_size: int = 1024,
        condition_type: str = "cartoon",
        drop_text_prob: float = 0.1,
        drop_image_prob: float = 0.1,
        seed: int = 0,
    ):
        self.base = base_dataset
        self.condition_size = condition_size
        self.target_size = target_size
        self.condition_type = condition_type
        self.drop_text_prob = drop_text_prob
        self.drop_image_prob = drop_image_prob
        self.seed = seed

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        rng = np.random.default_rng((self.seed, idx))
        data = self.base[idx]
        tag = data["tags"][0]
        td = data["target_description"]
        description = data.get(
            "description",
            f"Photo of a {self.TAG_PHRASES[tag]} cartoon character in a white "
            f"background. Character is facing {td['facing_direction']}. "
            f"Character pose is {td['pose']}.",
        )
        if rng.random() < self.drop_text_prob:
            description = ""
        if rng.random() < self.drop_image_prob:
            cond = np.zeros(
                (self.condition_size, self.condition_size, 3), np.float32
            )
        else:
            cond = _img_to_float(data["condition"], self.condition_size)
        return {
            "image": _img_to_float(data["target"], self.target_size),
            "condition": cond,
            "condition_type": self.condition_type,
            "description": description,
            "position_delta": np.array([0, -16]),
        }


def build_dataset(train_cfg, device="cuda") -> Any:
    """Dataset factory from a TrainConfig: dataset.type seed | subject |
    img | cartoon (the last three load Hugging Face datasets, imported
    here only).  ``device`` is the training device, where the img type's
    depth estimator runs."""
    ds_cfg = train_cfg.dataset
    typ = ds_cfg.type.lower()
    if typ == "seed":
        return SeedDataset(
            jsonl_path=ds_cfg.jsonl_path or ds_cfg.path,
            condition_size=ds_cfg.condition_size,
            condition_type=train_cfg.condition_type,
            image_dir=ds_cfg.image_dir,
            pkl_path=ds_cfg.pkl_path,
            image_size=ds_cfg.image_size,
        )
    # HF-dataset backed families
    from datasets import load_dataset

    if typ == "subject":
        base = load_dataset(ds_cfg.path or "Yuanshi/Subjects200K")["train"]
        # quality filter (reference train.py:95-110)
        base = base.filter(
            lambda item: bool(item.get("quality_assessment"))
            and all(
                item["quality_assessment"].get(k, 0) >= 5
                for k in ("compositeStructure", "objectConsistency",
                          "imageQuality")
            )
        )
        return SubjectPairDataset(
            base,
            condition_size=ds_cfg.condition_size,
            target_size=ds_cfg.target_size,
            image_size=ds_cfg.image_size,
            padding=ds_cfg.padding,
            condition_type=train_cfg.condition_type,
            drop_text_prob=ds_cfg.drop_text_prob,
            drop_image_prob=ds_cfg.drop_image_prob,
        )
    if typ == "img":
        # text-to-image-2M webdataset shards (reference train.py:121-128)
        if ds_cfg.urls:
            base = load_dataset(
                "webdataset", data_files={"train": ds_cfg.urls},
                split="train",
            )
        else:
            base = load_dataset(ds_cfg.path)["train"]
        return ImageConditionDataset(
            base,
            condition_size=ds_cfg.condition_size,
            target_size=ds_cfg.target_size,
            condition_type=train_cfg.condition_type,
            drop_text_prob=ds_cfg.drop_text_prob,
            drop_image_prob=ds_cfg.drop_image_prob,
            position_scale=ds_cfg.position_scale,
            device=device,
        )
    if typ == "cartoon":
        base = load_dataset(ds_cfg.path)["train"]
        return CartoonDataset(
            base,
            condition_size=ds_cfg.condition_size,
            target_size=ds_cfg.target_size,
            condition_type=train_cfg.condition_type,
            drop_text_prob=ds_cfg.drop_text_prob,
            drop_image_prob=ds_cfg.drop_image_prob,
        )
    raise ValueError(f"unknown dataset type {ds_cfg.type!r}")
