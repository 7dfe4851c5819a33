"""Random weights from a seed, made on the device in a few large draws.

`make` fills a layout tree (`perfbench.reference.layout`) with tensors:
one generator per (seed, tree tag, leaf kind), one draw over every leaf of
a kind, cut into the leaves and scaled per leaf.  The int8 codes are the
exception: each code leaf is its own draw and its own allocation, so a
transform that copies a leaf (the serving layout's fused q/k/v) frees the
original.  The same (seed, tag) gives the same tree on every call, so the
reference makes its own copy after the program's is freed.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List, Tuple

import torch

from perfbench.reference.layout import Leaf

# std of int8 codes drawn uniformly from -127..127
CODE_STD = math.sqrt((255 ** 2 - 1) / 12.0)

_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def derive_seed(seed: int, *tags: Any) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from the run's seed
    (any whole number) and tags naming the draw."""
    text = "/".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") & (2 ** 63 - 1)


def generator(seed: int, *tags: Any, device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, *tags))


def _leaves(tree, path="") -> List[Tuple[str, Leaf]]:
    if isinstance(tree, Leaf):
        return [(path, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = []
    for k, v in items:
        out.extend(_leaves(v, f"{path}/{k}" if path else str(k)))
    return out


def _rebuild(tree, values: Dict[str, torch.Tensor], path=""):
    if isinstance(tree, Leaf):
        return values[path]
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return [_rebuild(v, values, f"{path}/{i}" if path else str(i))
            for i, v in enumerate(tree)]


def _shaped(flat: torch.Tensor, leaves, fn) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for path, leaf in leaves:
        n = math.prod(leaf.shape)
        part = flat[at:at + n].view(leaf.shape)
        out[path] = fn(part, leaf).to(_DTYPES[leaf.dtype]).contiguous()
        at += n
    return out


def make(layout, seed: int, tag: str, device="cuda"):
    """The layout tree filled with tensors on ``device``, drawn from
    ``seed``; ``tag`` names the tree, so two trees of one seed differ."""
    by_kind: Dict[str, list] = {}
    for path, leaf in _leaves(layout):
        by_kind.setdefault(leaf.kind, []).append((path, leaf))
    values: Dict[str, torch.Tensor] = {}
    for kind, leaves in by_kind.items():
        total = sum(math.prod(leaf.shape) for _, leaf in leaves)
        if kind == "codes":
            for i, (path, leaf) in enumerate(leaves):
                gen = generator(seed, tag, kind, path, device=device)
                values[path] = torch.randint(-127, 128, leaf.shape,
                                             dtype=torch.int8, device=device,
                                             generator=gen)
            continue
        gen = generator(seed, tag, kind, device=device)
        flat = torch.empty(total, dtype=torch.float32, device=device)
        if kind in ("kernel", "bias", "qscale", "s4_log_dt"):
            flat.uniform_(-1.0, 1.0, generator=gen)
        elif kind in ("normal", "norm_weight", "norm_bias", "lora_a"):
            flat.normal_(generator=gen)
        elif kind in ("zeros", "s4_log_a", "s4_a_imag"):
            flat.zero_()
        else:
            raise ValueError(f"unknown leaf kind {kind!r}")
        values.update(_shaped(flat, leaves, _TRANSFORMS[kind]))
        del flat
    return _rebuild(layout, values)


def _s4_a_imag(part: torch.Tensor, leaf: Leaf) -> torch.Tensor:
    n = leaf.shape[-1]
    return part + math.pi * torch.arange(n, dtype=part.dtype,
                                         device=part.device)


def _s4_log_dt(part: torch.Tensor, leaf: Leaf) -> torch.Tensor:
    # U(log 1e-3, log 1e-1), the S4D-Lin initialisation
    lo, hi = math.log(1e-3), math.log(1e-1)
    return lo + (part + 1.0) * 0.5 * (hi - lo)


_TRANSFORMS = {
    # torch's default linear / conv initialisation U(-1/sqrt(fan_in), ..)
    "kernel": lambda p, leaf: p / math.sqrt(leaf.fan_in),
    "bias": lambda p, leaf: p / math.sqrt(leaf.fan_in),
    # per output channel, around unit gain: every int8 linear keeps its
    # input's variance, so each block moves the residual stream
    "qscale": lambda p, leaf: (1.0 + 0.25 * p) / (math.sqrt(leaf.fan_in)
                                                  * CODE_STD),
    "normal": lambda p, leaf: p * 1.0,
    "norm_weight": lambda p, leaf: 1.0 + 0.1 * p,
    "norm_bias": lambda p, leaf: 0.05 * p,
    "lora_a": lambda p, leaf: p / leaf.fan_in,
    "zeros": lambda p, leaf: p * 0.0,
    "s4_log_a": lambda p, leaf: p + math.log(0.5),
    "s4_a_imag": _s4_a_imag,
    "s4_log_dt": _s4_log_dt,
}
