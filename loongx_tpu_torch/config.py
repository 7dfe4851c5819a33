"""Typed configuration (counterpart of ``loongx_tpu/config.py``, this
package's own copy): the YAML schema of ``configs/*.yaml``, read from a
path or the ``XFL_CONFIG`` environment variable, validated into
dataclasses so that a mistyped key fails loudly.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml


@dataclass
class ModelFlags:
    """Flags steering the conditioned transformer forward.

    Mirrors the reference's ``model:`` block (train/config/seed_512.yaml:6-9;
    consumed at src/flux/block.py:106-128).
    """

    union_cond_attn: bool = True
    add_cond_attn: bool = False
    latent_lora: bool = False
    independent_condition: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class LoraConfig:
    """LoRA adapter spec (reference: train/config/seed_512.yaml:36-41)."""

    r: int = 4
    lora_alpha: int = 4
    init_lora_weights: str = "gaussian"
    # Regex matched against module paths, e.g. "transformer_blocks\\.\\d+\\.attn\\.to_k"
    target_modules: str = (
        r"(.*x_embedder|.*(?<!single_)transformer_blocks\.[0-9]+\.norm1\.linear"
        r"|.*(?<!single_)transformer_blocks\.[0-9]+\.attn\.to_k"
        r"|.*(?<!single_)transformer_blocks\.[0-9]+\.attn\.to_q"
        r"|.*(?<!single_)transformer_blocks\.[0-9]+\.attn\.to_v"
        r"|.*(?<!single_)transformer_blocks\.[0-9]+\.attn\.to_out\.0"
        r"|.*(?<!single_)transformer_blocks\.[0-9]+\.ff\.net\.2"
        r"|.*single_transformer_blocks\.[0-9]+\.norm\.linear"
        r"|.*single_transformer_blocks\.[0-9]+\.proj_mlp"
        r"|.*single_transformer_blocks\.[0-9]+\.proj_out"
        r"|.*single_transformer_blocks\.[0-9]+\.attn.to_k"
        r"|.*single_transformer_blocks\.[0-9]+\.attn.to_q"
        r"|.*single_transformer_blocks\.[0-9]+\.attn.to_v)"
    )


@dataclass
class OptimizerConfig:
    """Optimizer spec (reference: train/config/seed_512.yaml:43-48)."""

    type: str = "Prodigy"
    params: Dict[str, Any] = field(
        default_factory=lambda: {
            "lr": 1.0,
            "use_bias_correction": True,
            "safeguard_warmup": True,
            "weight_decay": 0.01,
        }
    )


@dataclass
class DatasetConfig:
    type: str = "seed"  # seed | subject | img | cartoon
    path: Optional[str] = None
    jsonl_path: Optional[str] = None  # reference schema alias for seed
    image_dir: str = ""
    pkl_path: Optional[str] = None
    urls: Optional[List[str]] = None  # webdataset shards (img datasets)
    cache_name: Optional[str] = None  # HF datasets cache tag (reference)
    condition_size: int = 512
    target_size: int = 512
    image_size: int = 512
    padding: int = 0
    drop_text_prob: float = 0.1
    drop_image_prob: float = 0.1
    position_scale: float = 1.0
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TrainConfig:
    batch_size: int = 1
    accumulate_grad_batches: int = 4
    gradient_checkpointing: bool = True
    max_steps: int = 6000
    sample_interval: int = 500
    save_interval: int = 1000
    save_path: str = "runs"
    gradient_clip_val: float = 0.5
    # the reference's SEED configs use "subject" for the source-image
    # condition (seed_512.yaml:19); biosignals ride separately
    condition_type: str = "subject"
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    dataloader_workers: int = 2
    lora_config: LoraConfig = field(default_factory=LoraConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    wandb: Optional[Dict[str, Any]] = None
    seed: int = 42
    # Stage text encoding: pre-encode every prompt the dataset can emit
    # with ONLY the T5/CLIP encoders resident, free them, then load the DiT
    # and train on the cached embeds; numerically identical to resident
    # encoding (tests/test_torch_train_loop.py).
    staged_text: bool = False
    # Train the CS3 biosignal encoders + DGF fusion alongside the LoRA.
    # Default False trains the LoRA factors only, as the reference's
    # released code does (see docs/TRAINING.md).
    train_encoders: bool = False


@dataclass
class Config:
    flux_path: str = "flux-dev"
    dtype: str = "bfloat16"
    model: ModelFlags = field(default_factory=ModelFlags)
    train: TrainConfig = field(default_factory=TrainConfig)
    # device-mesh axes: {tensor: t} splits the DiT over t ranks, the rest of
    # the processes torchrun starts split the batch; {data: d}, if given,
    # must equal world / t (train.loop.train_mesh)
    mesh: Dict[str, int] = field(default_factory=dict)


def _build(cls, data: Dict[str, Any]):
    """Recursively build a dataclass from a dict, erroring on unknown keys."""
    if data is None:
        return cls()
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            raise ValueError(
                f"Unknown config key {key!r} for {cls.__name__}; "
                f"valid keys: {sorted(fields)}"
            )
        ftype = fields[key].type
        nested = {
            "ModelFlags": ModelFlags,
            "TrainConfig": TrainConfig,
            "DatasetConfig": DatasetConfig,
            "LoraConfig": LoraConfig,
            "OptimizerConfig": OptimizerConfig,
        }
        if isinstance(ftype, str) and ftype in nested and isinstance(value, dict):
            kwargs[key] = _build(nested[ftype], value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def load_config(path: Optional[str] = None) -> Config:
    """Load a YAML config from ``path``, else from the ``XFL_CONFIG``
    environment variable, else the defaults."""
    path = path or os.environ.get("XFL_CONFIG")
    if not path:
        return Config()
    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    return _build(Config, raw)
