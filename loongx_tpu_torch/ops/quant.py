"""Weight-only int8 quantization of linear layers and the serving-time
weight transforms (counterpart of ``loongx_tpu/ops/quant.py``).

Quantized linears carry ``kernel_q`` int8 ``[..., in, out]`` and
``kernel_scale`` float32 ``[..., 1, out]`` (per-output-channel absmax/127)
in place of ``kernel``; block stacks keep their leading ``[NB]`` axis.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from loongx_tpu_torch.ops.nn import tree_leaves

Params = Dict[str, Any]


def quantize_linear(p: Params) -> Params:
    """One linear dict {kernel, bias?, lora_*...} -> int8-weight form."""
    kernel = p["kernel"].float()
    absmax = kernel.abs().amax(dim=-2, keepdim=True)
    # a tensor divisor keeps the true quotient on CUDA too (a Python scalar
    # divisor becomes a multiply by its reciprocal there)
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        absmax / absmax.new_full((), 127.0))
    q = torch.clamp(torch.round(kernel / scale), -127, 127).to(torch.int8)
    out = {k: v for k, v in p.items() if k != "kernel"}
    out["kernel_q"] = q
    out["kernel_scale"] = scale
    return out


def dequant_kernel(p: Params, dtype=torch.bfloat16) -> torch.Tensor:
    return (p["kernel_q"].float() * p["kernel_scale"]).to(dtype)


def quantize_tree(params: Params,
                  predicate: Optional[Callable[[str, Params], bool]] = None
                  ) -> Params:
    """Quantize every linear subtree ({kernel: ...}); ``predicate(path,
    leaf_dict)`` may exclude layers."""
    def walk(tree, path=""):
        if isinstance(tree, dict):
            if "kernel" in tree:
                if predicate is None or predicate(path, tree):
                    return quantize_linear(tree)
                return tree
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(tree)]
        return tree

    return walk(params)


def quantized_bytes(params: Params) -> int:
    """Bytes held by every tensor leaf of a (quantized) tree."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def random_quantized_like(shapes: Params, *, generator=None,
                          device="cuda") -> Params:
    """Random int8-quantized tree with the structure of ``shapes`` (a tree
    built on the ``meta`` device, so the float original never exists):
    uniform int8 bits (-128..127), scale 0.02/sqrt(fan_in)/127, zero biases
    and extra linear leaves, ones for float leaves (norms), zeros else."""
    def walk(tree):
        if isinstance(tree, dict):
            if "kernel" in tree and not isinstance(tree["kernel"], dict):
                shape = tuple(tree["kernel"].shape)
                out = {"kernel_q": torch.randint(
                    -128, 128, shape, dtype=torch.int8, device=device,
                    generator=generator)}
                out["kernel_scale"] = torch.full(
                    shape[:-2] + (1, shape[-1]),
                    0.02 / (shape[-2] ** 0.5) / 127.0,
                    dtype=torch.float32, device=device)
                for name, leaf in tree.items():
                    if name != "kernel":
                        out[name] = torch.zeros(leaf.shape, dtype=leaf.dtype,
                                                device=device)
                return out
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if tree.dtype.is_floating_point:
            return torch.ones(tree.shape, dtype=tree.dtype, device=device)
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)

    return walk(shapes)


def fuse_qkv_projections(flux_params: Params, tp_layout: bool = False
                         ) -> Params:
    """Concatenate each attention's q/k/v projections along the output axis
    (``to_qkv`` / ``add_qkv_proj``) so one matmul serves all three.  Exact;
    skipped where a LoRA delta sits on q/k/v or the three differ in leaves.
    Returns a new tree; the sources are dropped from it.

    ``tp_layout`` stacks q/k/v on a new axis instead: kernel_q [NB, K, 3,
    H], kernel_scale [NB, 1, 3, H], bias [NB, 3, H], so a tensor split of
    the head axis (the last) cuts all three alike and each rank holds a
    whole fused qkv for its heads (`parallel.tp_quant.
    tp_quant_qkv_stacked`); a column split of the flat [K, 3H] axis would
    cut across the q/k/v boundaries."""
    def fuse_attn(attn: Params) -> Params:
        out = dict(attn)
        for stem, fused_name in (("to_{}", "to_qkv"),
                                 ("add_{}_proj", "add_qkv_proj")):
            names = [stem.format(x) for x in ("q", "k", "v")]
            if not all(n in attn for n in names):
                continue
            parts = [attn[n] for n in names]
            if any("lora_a" in p for p in parts):
                continue
            if not (set(parts[0]) == set(parts[1]) == set(parts[2])):
                continue
            join = torch.stack if tp_layout else torch.cat
            out[fused_name] = {
                name: join([p[name] for p in parts], dim=-2 if tp_layout
                           else -1)
                for name in parts[0]
            }
            for n in names:
                del out[n]
        return out

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (fuse_attn(v) if k == "attn" else walk(v))
                    for k, v in tree.items()}
        return tree

    return walk(flux_params)


def split_single_proj_out(flux_params: Params, hidden: int) -> Params:
    """Split the stacked single-block ``proj_out`` (input rows [hidden |
    mlp]) into ``proj_out`` (K = hidden, keeps the bias) and
    ``proj_out_mlp``, so the [S, hidden + mlp] concat is never built.
    Exact; skipped when a LoRA delta sits on proj_out."""
    sgl = flux_params.get("single_blocks")
    if not isinstance(sgl, dict):
        return flux_params
    p = sgl.get("proj_out")
    if not isinstance(p, dict) or "lora_a" in p or "proj_out_mlp" in sgl:
        return flux_params
    wname = "kernel_q" if "kernel_q" in p else "kernel"
    if wname not in p:
        return flux_params
    w = p[wname]
    if w.ndim != 3 or w.shape[1] <= hidden:
        return flux_params
    attn_part = {k: v for k, v in p.items() if k != wname}
    attn_part[wname] = w[:, :hidden].contiguous()
    mlp_part = {k: v for k, v in p.items() if k not in (wname, "bias")}
    mlp_part[wname] = w[:, hidden:].contiguous()
    out_sgl = dict(sgl)
    out_sgl["proj_out"] = attn_part
    out_sgl["proj_out_mlp"] = mlp_part
    out = dict(flux_params)
    out["single_blocks"] = out_sgl
    return out
