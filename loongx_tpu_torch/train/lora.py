"""LoRA as leaves of the param tree (counterpart of
``loongx_tpu/train/lora.py``).

Targeted linears gain ``lora_a`` [.., in, r], ``lora_b`` [.., r, out] and
a ``lora_scale`` leaf (alpha / r, one per stacked block);
``models/flux/model.py::linear`` adds ``(x A) B * scale`` where the call
site's ``use_lora`` gate is on.  Stacked block trees get stacked factors.
peft-style init: A ~ N(0, 1) / r, B = 0.  `lora_state_dict` /
`load_lora_state_dict` move the LoRA leaves in and out of a tree as a flat
{path/leaf: tensor} dict (the adapter registry's storage).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

Params = Dict[str, Any]

# The reference's target regex, translated to tree paths (stacked-block
# leading axes implicit).
DEFAULT_TARGETS: Tuple[str, ...] = (
    r"^x_embedder$",
    r"^double_blocks/norm1/linear$",
    r"^double_blocks/attn/to_(q|k|v)$",
    r"^double_blocks/attn/to_out$",
    r"^double_blocks/ff/out$",
    r"^single_blocks/norm/linear$",
    r"^single_blocks/attn/to_(q|k|v)$",
    r"^single_blocks/proj_mlp$",
    r"^single_blocks/proj_out$",
)

# The layers whose call sites can apply a LoRA delta (``use_lora`` can be
# on): an adapter anywhere else would get exactly-zero gradients, so
# `add_lora` refuses it.
FLUX_APPLIABLE_TARGETS: Tuple[str, ...] = DEFAULT_TARGETS

LORA_FACTORS = ("lora_a", "lora_b")


def _walk_linears(tree: Params, prefix: str = "") -> Iterator[Tuple[str, Params]]:
    """(path, dict) of every linear subtree: {kernel} or {kernel_q, ...}."""
    if isinstance(tree, dict):
        if "kernel" in tree or "kernel_q" in tree:
            yield prefix, tree
        else:
            for k, v in tree.items():
                yield from _walk_linears(v, f"{prefix}/{k}" if prefix else k)


def _copy_dicts(tree):
    """The same tree with new dicts (leaves shared), so adding leaves never
    touches the caller's tree."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def add_lora(params: Params, r: int = 4, alpha: int = 4,
             targets: Tuple[str, ...] = DEFAULT_TARGETS,
             dtype=torch.bfloat16,
             appliable: Optional[Tuple[str, ...]] = FLUX_APPLIABLE_TARGETS,
             generator: Optional[torch.Generator] = None) -> Params:
    """A copy of ``params`` with LoRA leaves on the targeted linears, made
    on each kernel's device.  Refuses (ValueError) a tree in the serving
    forms (fused qkv, split proj_out), targets that match nothing, and, on a
    full flux tree, matches outside ``appliable`` (pass None for non-flux
    trees)."""
    linears = list(_walk_linears(params))
    fused = [p for p, _ in linears if p.endswith(("to_qkv", "add_qkv_proj"))]
    if fused:
        raise ValueError(
            f"param tree has serving-fused qkv projections ({fused[:2]}...): "
            "build the training tree without fuse_qkv_projections before "
            "adding LoRA adapters")
    if any(p.endswith("proj_out_mlp") for p, _ in linears):
        raise ValueError(
            "param tree has the serving proj_out K-split "
            "(single_blocks/proj_out_mlp): build the training tree without "
            "split_single_proj_out before adding LoRA adapters")
    params = _copy_dicts(params)
    patterns = [re.compile(t) for t in targets]
    matched = [(path, leaf) for path, leaf in _walk_linears(params)
               if any(p.search(path) for p in patterns)]
    if not matched:
        raise ValueError(f"no linears matched LoRA targets {targets}")
    full_flux = (isinstance(params, dict) and "double_blocks" in params
                 and "single_blocks" in params)
    if appliable is not None and full_flux:
        ok = [re.compile(t) for t in appliable]
        dead = [p for p, _ in matched if not any(a.search(p) for a in ok)]
        if dead:
            raise ValueError(
                "LoRA targets match layers the forward never applies "
                f"adapters to (use_lora=False call sites): {dead}. These "
                "would train with exactly-zero gradients; target a subset of "
                "FLUX_APPLIABLE_TARGETS, or pass appliable=None for a "
                "non-flux tree.")
    for _, leaf in matched:
        kernel = leaf.get("kernel", leaf.get("kernel_q"))
        *stack, d_in, d_out = kernel.shape
        a = torch.empty(*stack, d_in, r, dtype=torch.float32, device=kernel.device)
        a.normal_(generator=generator)
        leaf["lora_a"] = (a / r).to(dtype)
        leaf["lora_b"] = torch.zeros(*stack, r, d_out, dtype=dtype,
                                     device=kernel.device)
        leaf["lora_scale"] = torch.full(tuple(stack), alpha / r,
                                        dtype=torch.float32, device=kernel.device)
    return params


def lora_mask(params: Any, _name: str = "") -> Any:
    """Boolean tree of ``params``' structure: True at lora_a / lora_b (the
    trainable set), False elsewhere."""
    if isinstance(params, dict):
        return {k: lora_mask(v, k) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [lora_mask(v, _name) for v in params]
    return _name in LORA_FACTORS


def merge_lora(params: Params) -> Params:
    """Fold the LoRA deltas into the base kernels (the serving fast path):
    kernel + (A B) * scale in float32, cast back to the kernel's dtype, the
    LoRA leaves dropped.  An int8 kernel with a LoRA raises ValueError:
    folding would requantize it; serve its deltas live instead."""
    def merge_tree(tree):
        if isinstance(tree, dict):
            if "kernel_q" in tree and "lora_a" in tree:
                raise ValueError(
                    "merge_lora: cannot fold a LoRA delta into an "
                    "int8-quantized kernel; keep the deltas live (QLoRA "
                    "serving) or merge before quantize()")
            if "kernel" in tree and "lora_a" in tree:
                kernel = tree["kernel"]
                delta = torch.einsum(
                    "...ir,...ro->...io", tree["lora_a"].float(),
                    tree["lora_b"].float()) * tree["lora_scale"][..., None, None]
                new = {k: v for k, v in tree.items()
                       if k not in ("lora_a", "lora_b", "lora_scale")}
                new["kernel"] = (kernel.float() + delta).to(kernel.dtype)
                return new
            return {k: merge_tree(v) for k, v in tree.items()}
        return tree

    return merge_tree(params)


def lora_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """Flat {path/leaf: tensor} of the LoRA leaves, lora_scale included
    (skipped where None, as in a partitioned trainable tree)."""
    out = {}
    for path, leaf in _walk_linears(params):
        if leaf.get("lora_a") is not None:
            out[f"{path}/lora_a"] = leaf["lora_a"]
            out[f"{path}/lora_b"] = leaf["lora_b"]
            if leaf.get("lora_scale") is not None:
                out[f"{path}/lora_scale"] = leaf["lora_scale"]
    return out


def _route_split_proj_out(index, state: Dict[str, Any]) -> Dict[str, Any]:
    """Fit a LoRA state to the serving-time single-block proj_out K-split
    (`ops.quant.split_single_proj_out`).  A factor trained on the whole
    [hidden + mlp]-row proj_out is split by rows onto proj_out and
    proj_out_mlp (exact: x A B = x_attn A[:h] B + x_mlp A[h:] B); a state
    saved from a split tree loads into a whole one by concatenating the rows
    back."""
    out = dict(state)
    paths = {k.rsplit("/", 1)[0] for k in state}
    for path in sorted(paths):
        if path.endswith("/proj_out") and path in index:
            mlp = path + "_mlp"
            a_key = f"{path}/lora_a"
            if mlp in index and a_key in out:
                kernel = index[path].get("kernel", index[path].get("kernel_q"))
                k_rows = kernel.shape[-2]
                a = torch.as_tensor(out[a_key])
                if a.shape[-2] > k_rows:
                    out[a_key] = a[..., :k_rows, :]
                    out[f"{mlp}/lora_a"] = a[..., k_rows:, :]
                    for leaf in ("lora_b", "lora_scale"):
                        if f"{path}/{leaf}" in out:
                            out[f"{mlp}/{leaf}"] = out[f"{path}/{leaf}"]
        elif path.endswith("/proj_out_mlp") and path not in index:
            base = path[: -len("_mlp")]
            a_base, a_mlp = f"{base}/lora_a", f"{path}/lora_a"
            if base in index and a_base in out and a_mlp in out:
                out[a_base] = torch.cat([torch.as_tensor(out[a_base]),
                                         torch.as_tensor(out[a_mlp])], dim=-2)
                for leaf in ("lora_a", "lora_b", "lora_scale"):
                    out.pop(f"{path}/{leaf}", None)
    return out


def load_lora_state_dict(params: Params, state: Dict[str, Any],
                         strict_shapes: bool = True) -> Params:
    """Inverse of `lora_state_dict`: writes the state's leaves into
    ``params`` (mutated and returned), each on its kernel's device.
    ``strict_shapes=False`` allows factors of another rank.  Factors without
    a lora_scale entry get scale 1.0."""
    index = {path: leaf for path, leaf in _walk_linears(params)}
    state = _route_split_proj_out(index, state)
    scale_paths, factor_paths = set(), {}
    for key, value in state.items():
        path, leaf_name = key.rsplit("/", 1)
        if path not in index:
            raise KeyError(f"no linear at {path!r} in params")
        tgt = index[path]
        kernel = tgt.get("kernel", tgt.get("kernel_q"))
        value = torch.as_tensor(value).to(kernel.device)
        if leaf_name == "lora_a" and (kernel.ndim == value.ndim
                                      and kernel.shape[-2] != value.shape[-2]):
            raise ValueError(
                f"{key}: lora_a input dim {value.shape[-2]} does not match "
                f"the kernel's {kernel.shape[-2]} at {path!r} (kernel "
                f"{tuple(kernel.shape)}) — wrong adapter for this "
                "model/layout?")
        if (strict_shapes and tgt.get(leaf_name) is not None
                and tgt[leaf_name].shape != value.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} != expected "
                             f"{tuple(tgt[leaf_name].shape)}")
        tgt[leaf_name] = value
        if leaf_name == "lora_scale":
            scale_paths.add(path)
        else:
            factor_paths[path] = (tuple(value.shape[:-2]), value.device)
    # no lora_scale entry means scale 1.0, even over a deactivated (zeroed)
    # scale already in the tree
    for path, (stack, device) in factor_paths.items():
        if path not in scale_paths:
            index[path]["lora_scale"] = torch.ones(stack, dtype=torch.float32,
                                                   device=device)
    return params
