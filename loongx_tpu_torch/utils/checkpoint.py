"""Checkpoints (counterpart of ``loongx_tpu/utils/checkpoint.py``): LoRA
safetensors files and pipeline directories.

LoRA files use exactly the JAX package's format (`save_lora_safetensors`:
``lora.safetensors`` with the LoRA leaves' tree paths joined by ".",
float32), so a LoRA saved by either package loads in the other.

A pipeline directory holds the JAX package's ``config.json`` (the four
model configs and the compute dtype) and one safetensors file per
component, ``params/<component>.safetensors`` (flux, vae, t5, clip,
encoders, dgf), each the component's tree flattened to "/"-joined paths;
the file's metadata names the tree's lists and empty containers so the
tree comes back exactly.  The JAX package's directories hold orbax trees
instead, which cannot be read without JAX: convert the published weights
again with ``python -m loongx_tpu_torch.cli.convert``.  Tokenizer
directories (``t5_tokenizer/``, ``clip_tokenizer/``) are loaded with
``transformers`` where it is installed.

Files are read with the ``safetensors`` package's ``safe_open``, a tensor
at a time onto the target device, and written with its ``save_file``, a
component at a time (the component is copied to the host first).

Train-state checkpoints (`save_train_checkpoint`) are this package's own
format: ``<root>/step_<n>/trainable.safetensors`` (the trainable tree's
tensor leaves, as `save_tree` writes a tree) and ``train_state.pt`` (the
optimizer step and the optimizer's ``state_dict``, accumulator and open
window included), with the run's config fingerprint in
``<root>/fingerprint.json`` (the JAX package's keys).  The JAX package's
train states are orbax trees and are refused, naming the format.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, Optional

import torch

_TREE_KEY = "loongx_tree"


# ---------------------------------------------------------------------------
# LoRA safetensors (the JAX package's interop format)
# ---------------------------------------------------------------------------


def _lora_file(path: str) -> str:
    return path if path.endswith(".safetensors") else os.path.join(
        path, "lora.safetensors")


def save_lora_safetensors(flux_params, path: str) -> str:
    """Save the LoRA leaves of ``flux_params`` as ``<path>/lora.safetensors``
    (float32, tree paths joined by "."); returns the file's path."""
    from safetensors.torch import save_file

    from loongx_tpu_torch.train.lora import lora_state_dict

    os.makedirs(path, exist_ok=True)
    sd = {k.replace("/", "."): v.detach().float().cpu().contiguous()
          for k, v in lora_state_dict(flux_params).items()}
    out = os.path.join(path, "lora.safetensors")
    save_file(sd, out)
    return out


def load_lora_safetensors(flux_params, path: str):
    """Load a LoRA file (or ``<path>/lora.safetensors``) into
    ``flux_params`` (mutated and returned, each leaf on its kernel's
    device)."""
    from safetensors import safe_open

    from loongx_tpu_torch.train.lora import load_lora_state_dict

    with safe_open(_lora_file(path), framework="pt") as f:
        sd = {k.replace(".lora_", "/lora_").replace(".", "/"): f.get_tensor(k)
              for k in f.keys()}
    return load_lora_state_dict(flux_params, sd)


# ---------------------------------------------------------------------------
# Param trees <-> flat safetensors files
# ---------------------------------------------------------------------------


def flatten_tree(tree):
    """(flat {"a/b/c": tensor}, {path: "list" | "dict"} for every list and
    every empty dict) of a tree of dicts and lists."""
    flat: Dict[str, torch.Tensor] = {}
    containers: Dict[str, str] = {}

    def walk(node, path):
        if isinstance(node, dict):
            if not node:
                containers[path] = "dict"
            items = node.items()
        elif isinstance(node, (list, tuple)):
            containers[path] = "list"
            items = enumerate(node)
        elif isinstance(node, torch.Tensor):
            flat[path] = node
            return
        else:
            raise TypeError(f"tree leaf {path!r} is a {type(node).__name__}, "
                            "not a tensor")
        for k, v in items:
            k = str(k)
            if "/" in k:
                raise ValueError(f"tree key {k!r} under {path!r} contains '/'")
            walk(v, f"{path}/{k}" if path else k)

    walk(tree, "")
    return flat, containers


def unflatten_tree(flat: Dict[str, Any], containers: Dict[str, str]):
    """Inverse of `flatten_tree`."""
    root: Dict[str, Any] = {}

    def node_at(parts):
        node = root
        for p in parts:
            node = node.setdefault(p, {})
        return node

    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node_at(parents)[leaf] = value
    for path in containers:
        node_at(path.split("/") if path else [])

    def fix(node, path):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        if containers.get(path) == "list":
            return [out[str(i)] for i in range(len(out))]
        return out

    return fix(root, "")


def save_tree(tree, path: str) -> None:
    """Write one param tree to a safetensors file (each leaf copied to the
    host, so views of one storage are written as tensors of their own)."""
    from safetensors.torch import save_file

    flat, containers = flatten_tree(tree)
    flat = {k: v.detach().to("cpu", copy=True).contiguous()
            for k, v in flat.items()}
    save_file(flat, path, {_TREE_KEY: json.dumps(containers, sort_keys=True)})


def load_tree(path: str, device="cuda"):
    """Read a tree written by `save_tree`, one tensor at a time from the
    mapped file onto ``device`` (a copy each: the file is never held whole
    in host memory when ``device`` is a GPU)."""
    from safetensors import safe_open

    with safe_open(path, framework="pt") as f:
        containers = json.loads((f.metadata() or {}).get(_TREE_KEY, "{}"))
        flat = {name: f.get_tensor(name).to(device, copy=True)
                for name in f.keys()}
    return unflatten_tree(flat, containers)


# ---------------------------------------------------------------------------
# Train-state checkpoints (resume)
# ---------------------------------------------------------------------------

_TRAINABLE_FILE = "trainable.safetensors"
_STATE_FILE = "train_state.pt"


def _prune(tree):
    """The tree without its None leaves (a partitioned tree's other half)."""
    if isinstance(tree, dict):
        return {k: _prune(v) for k, v in tree.items() if v is not None}
    if isinstance(tree, (list, tuple)):
        return [_prune(v) for v in tree]
    return tree


def save_train_checkpoint(path: str, step: int, trainable, optimizer,
                          fingerprint: Optional[Dict[str, Any]] = None) -> str:
    """Save the trainable leaves, the optimizer's state and the step under
    ``<path>/step_<step>`` for an exact resume; ``fingerprint`` (the config
    facts a resume must match) goes to ``<path>/fingerprint.json``.  The
    step directory is written under a temporary name and renamed, so a
    crash leaves no half-written step behind.  Returns the step
    directory."""
    root = os.path.abspath(path)
    os.makedirs(root, exist_ok=True)
    if fingerprint is not None:
        with open(os.path.join(root, "fingerprint.json"), "w") as f:
            json.dump(fingerprint, f, indent=2, sort_keys=True)
    out = os.path.join(root, f"step_{step}")
    tmp = f"{out}.tmp{os.getpid()}"
    os.makedirs(tmp)
    save_tree(_prune(trainable), os.path.join(tmp, _TRAINABLE_FILE))
    torch.save({"step": int(step), "optimizer": optimizer.state_dict()},
               os.path.join(tmp, _STATE_FILE))
    os.replace(tmp, out)
    return out


def load_fingerprint(path: str) -> Optional[Dict[str, Any]]:
    """The config fingerprint saved beside a run's step directories (None
    where there is none)."""
    fp = os.path.join(path, "fingerprint.json")
    if not os.path.isfile(fp):
        return None
    with open(fp) as f:
        return json.load(f)


def load_train_checkpoint(path: str, trainable, optimizer) -> int:
    """Restore a `save_train_checkpoint` step directory into the live
    ``trainable`` leaves (copied in place, bit for bit) and ``optimizer``
    (its ``load_state_dict``); returns the step.  A step directory of the
    JAX package (orbax) raises: it cannot be read without JAX."""
    from safetensors import safe_open

    tfile = os.path.join(path, _TRAINABLE_FILE)
    if not os.path.isfile(tfile):
        raise ValueError(
            f"{path} is not a train state of this package (no "
            f"{_TRAINABLE_FILE}): a directory written by the JAX package "
            "holds orbax trees, which cannot be read without JAX. Resume "
            "from a run of this package, or start afresh (resume=False / "
            "--no_resume, or another save_path)")
    live, _ = flatten_tree(_prune(trainable))
    with safe_open(tfile, framework="pt") as f:
        if set(f.keys()) != set(live):
            raise ValueError(f"{tfile}: its leaves do not match the trainable "
                             f"tree ({sorted(set(f.keys()) ^ set(live))[:5]})")
        with torch.no_grad():
            for name, leaf in live.items():
                saved = f.get_tensor(name)
                if saved.shape != leaf.shape or saved.dtype != leaf.dtype:
                    raise ValueError(
                        f"{tfile}: {name} is {saved.dtype} "
                        f"{tuple(saved.shape)}, the tree's {leaf.dtype} "
                        f"{tuple(leaf.shape)}")
                leaf.copy_(saved)
    state = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                       weights_only=True)
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def latest_checkpoint(path: str) -> Optional[str]:
    """The ``step_<n>`` directory with the largest n under ``path``."""
    if not os.path.isdir(path):
        return None
    steps = [int(n[5:]) for n in os.listdir(path)
             if n.startswith("step_") and n[5:].isdigit()]
    return os.path.join(path, f"step_{max(steps)}") if steps else None


# ---------------------------------------------------------------------------
# Pipeline directories
# ---------------------------------------------------------------------------


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save_pipeline(pipe, path: str) -> str:
    """Write ``config.json`` (the JAX package's: flux, vae, t5, clip and
    dtype; a missing config is written as its full-size default) and
    ``params/<component>.safetensors`` for every component of
    ``pipe.params``."""
    from loongx_tpu_torch.models.flux.vae import VAEConfig
    from loongx_tpu_torch.models.text.clip import CLIPTextConfig
    from loongx_tpu_torch.models.text.t5 import T5Config

    os.makedirs(os.path.join(path, "params"), exist_ok=True)
    cfgs = {
        "flux": dataclasses.asdict(pipe.flux_cfg),
        "vae": dataclasses.asdict(pipe.vae_cfg or VAEConfig.flux()),
        "t5": dataclasses.asdict(pipe.t5_cfg or T5Config.xxl()),
        "clip": dataclasses.asdict(pipe.clip_cfg or CLIPTextConfig.large()),
        "dtype": _dtype_name(pipe.dtype),
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfgs, f, indent=2)
    for name, tree in pipe.params.items():
        save_tree(tree, os.path.join(path, "params", f"{name}.safetensors"))
    return path


def load_configs(path: str):
    """(flux, vae, t5, clip configs, dtype name) of a pipeline directory's
    ``config.json``; lists become tuples, as the JAX package builds them."""
    from loongx_tpu_torch.models.flux.model import FluxConfig
    from loongx_tpu_torch.models.flux.vae import VAEConfig
    from loongx_tpu_torch.models.text.clip import CLIPTextConfig
    from loongx_tpu_torch.models.text.t5 import T5Config

    with open(os.path.join(path, "config.json")) as f:
        cfgs = json.load(f)

    def build(cls, d):
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items()})

    return (build(FluxConfig, cfgs["flux"]), build(VAEConfig, cfgs["vae"]),
            build(T5Config, cfgs["t5"]), build(CLIPTextConfig, cfgs["clip"]),
            cfgs.get("dtype", "bfloat16"))


def component_files(path: str) -> Dict[str, str]:
    """{component: file} of a pipeline directory's ``params/``.  A directory
    in the JAX package's orbax layout raises, naming the converter."""
    params_dir = os.path.join(path, "params")
    names = sorted(os.listdir(params_dir)) if os.path.isdir(params_dir) else []
    files = {n[:-len(".safetensors")]: os.path.join(params_dir, n)
             for n in names if n.endswith(".safetensors")}
    if not files and any(os.path.isdir(os.path.join(params_dir, n))
                         for n in names):
        raise ValueError(
            f"{path}: the params are orbax checkpoints (a directory converted "
            "for the JAX package), which this package cannot read. Convert "
            "the published weights again with python -m "
            "loongx_tpu_torch.cli.convert")
    return files


def _tok(path: str, cls_name: str, sub: str):
    tok_dir = os.path.join(path, sub)
    if not os.path.isdir(tok_dir):
        return None
    try:
        import transformers

        return getattr(transformers, cls_name).from_pretrained(tok_dir)
    except Exception as exc:  # a missing package or an unreadable directory
        print(f"[checkpoint] tokenizer {sub} unavailable: {exc}")
        return None


def load_pipeline(path: str, dtype: Optional[torch.dtype] = None,
                  components: Optional[Iterable[str]] = None, device="cuda"):
    """Load a pipeline directory onto ``device``.  ``components`` restricts
    which param files are read (e.g. ("flux", "vae", "encoders", "dgf") for
    the deployed replace mode, which never runs the text encoders); None
    reads every one present."""
    from loongx_tpu_torch.models.pipeline import LoongXPipeline

    flux_cfg, vae_cfg, t5_cfg, clip_cfg, dtype_name = load_configs(path)
    files = component_files(path)
    if components is not None:
        components = set(components)
        files = {k: v for k, v in files.items() if k in components}
    params = {name: load_tree(f, device) for name, f in files.items()}
    return LoongXPipeline(
        flux_cfg, vae_cfg, params, dtype or getattr(torch, dtype_name),
        t5_cfg=t5_cfg, clip_cfg=clip_cfg,
        t5_tokenizer=_tok(path, "T5TokenizerFast", "t5_tokenizer"),
        clip_tokenizer=_tok(path, "CLIPTokenizer", "clip_tokenizer"))
