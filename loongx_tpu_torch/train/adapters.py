"""Named LoRA adapters selected per generation call (counterpart of
``loongx_tpu/train/adapters.py``, the peft ``set_adapters`` equivalent).

The DiT consumes exactly one set of (lora_a, lora_b, lora_scale) leaves in
its param tree; activating an adapter writes its factors and scale into
those leaves.  Each adapter is stored as a flat LoRA state dict
(`train.lora.lora_state_dict`) plus an optional scale.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from loongx_tpu_torch.train.lora import (
    Params, _copy_dicts, _walk_linears, load_lora_state_dict, lora_state_dict,
)


class AdapterRegistry:
    """Holds named LoRA adapters and activates one into a param tree."""

    def __init__(self):
        self._adapters: Dict[str, Tuple[Dict[str, Any], Optional[float]]] = {}

    def add(self, name: str, state: Dict[str, Any],
            scale: Optional[float] = None) -> None:
        """Register a flat {path/lora_a|lora_b[|lora_scale]: tensor}
        adapter.  scale=None keeps the state's own lora_scale entries (1.0
        where absent); a float overrides them all."""
        if not state:
            raise ValueError(f"adapter {name!r}: empty state dict")
        self._adapters[name] = (dict(state),
                                None if scale is None else float(scale))

    def add_from_params(self, name: str, params: Params,
                        scale: Optional[float] = None) -> None:
        """Capture the LoRA leaves currently in ``params`` as an adapter."""
        self.add(name, lora_state_dict(params), scale)

    def names(self):
        return list(self._adapters)

    def __contains__(self, name: str) -> bool:
        return name in self._adapters

    def activate(self, params: Params, name: str) -> Params:
        """``params`` with adapter ``name``'s factors and scale set, every
        other lora scale zeroed first (adapters never blend).  KeyError,
        listing the registered names, for an unknown adapter."""
        if name not in self._adapters:
            raise KeyError(f"unknown adapter {name!r}; registered: {self.names()}")
        state, scale = self._adapters[name]
        params = self.deactivate(params)
        params = load_lora_state_dict(params, state, strict_shapes=False)
        covered = {k.rsplit("/", 1)[0] for k in state}
        for lpath, leaf in _walk_linears(params):
            if lpath not in covered:
                continue
            stack = tuple(leaf["lora_a"].shape[:-2])
            device = leaf["lora_a"].device
            if scale is not None:
                leaf["lora_scale"] = torch.full(stack, scale, dtype=torch.float32,
                                                device=device)
            elif f"{lpath}/lora_scale" not in state:
                leaf["lora_scale"] = torch.ones(stack, dtype=torch.float32,
                                                device=device)
        return params

    def deactivate(self, params: Params) -> Params:
        """A copy of ``params`` (new dicts, leaves shared) with every
        lora_scale zeroed: the base weights, LoRA leaves kept."""
        params = _copy_dicts(params)
        for _, leaf in _walk_linears(params):
            if "lora_scale" in leaf:
                leaf["lora_scale"] = torch.zeros_like(leaf["lora_scale"])
        return params
