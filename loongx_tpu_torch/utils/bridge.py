"""Weight bridge: the JAX package's parameter trees <-> this package's.

The JAX side hands over its tree as nested dicts (and the S4 ``blocks``
lists) of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``; the
bridge returns the same tree of torch tensors on a device, every layout kept
as it is: stacked ``[NB, ...]`` block trees, ``kernel`` ``[in, out]`` or
``kernel_q`` int8 / ``kernel_scale`` ``[..., 1, out]``, ``bias``, the LoRA
leaves, the fused ``to_qkv`` / ``add_qkv_proj`` and split ``proj_out`` /
``proj_out_mlp`` serving forms, HWIO conv kernels, the S4D parameters and
the T5 / CLIP text encoders (float or int8 block stacks, embeddings), the
CLIP vision and DINO ViT towers, Depth-Anything (its per-block list,
layer scales and DPT neck), Whisper and Marian.  A leaf name it does not
know raises instead of being dropped; a leaf that is already a tensor is
moved to ``device``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

KNOWN_LEAVES = frozenset({
    # linears (plain, int8, LoRA) and convolutions
    "kernel", "kernel_q", "kernel_scale", "bias",
    "lora_a", "lora_b", "lora_scale",
    # norms
    "weight",
    # S4D layers
    "log_A_real", "A_imag", "C", "log_dt", "D",
    # text encoders: T5 token embedding and relative-position bias, CLIP
    # token and position embeddings
    "embed", "rel_pos_bias", "token_embed", "pos_embed",
    # evaluation towers: the CLIP vision class embedding, the DINO ViT's
    # CLS token
    "class_embed", "cls_token",
    # Depth-Anything: the DINOv2 CLS token and position table, the layer
    # scales of each block
    "cls", "pos", "ls1", "ls2",
    # the speech path: Whisper's encoder and decoder position tables,
    # Marian's final-logits bias (its positions are "pos")
    "enc_pos", "dec_pos", "logits_bias",
})


def _to_tensor(x: Any, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from a JAX array
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def from_numpy_tree(tree: Any, device="cuda", _path: str = "") -> Any:
    """Numpy param tree (JAX layout) -> torch tensors on ``device``."""
    if isinstance(tree, dict):
        out = {}
        for name, value in tree.items():
            path = f"{_path}/{name}" if _path else str(name)
            if isinstance(value, (dict, list, tuple)):
                out[name] = from_numpy_tree(value, device, path)
            elif name in KNOWN_LEAVES:
                out[name] = _to_tensor(value, device)
            else:
                raise KeyError(f"unknown parameter leaf {path!r}")
        return out
    if isinstance(tree, (list, tuple)):
        return [from_numpy_tree(v, device, f"{_path}/{i}")
                for i, v in enumerate(tree)]
    raise TypeError(f"parameter tree node {_path!r} is a bare "
                    f"{type(tree).__name__}, not a dict of named leaves")


def to_numpy_tree(tree: Any) -> Any:
    """Torch param tree -> numpy (bfloat16 as ml_dtypes when available,
    else its raw uint16 bits), the inverse of `from_numpy_tree`."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        try:
            import ml_dtypes
        except ImportError:
            return bits
        return bits.view(ml_dtypes.bfloat16)
    return t.numpy()
