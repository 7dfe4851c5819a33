"""Functional NN building blocks on torch tensors (dict-of-tensors params).

Counterpart of ``loongx_tpu/ops/nn.py``.  Params stay plain nested dicts in
the JAX package's layouts (``kernel`` is ``[in, out]``), so a tree bridged
from JAX (``utils/bridge.py``) drops straight in.  Matmuls take float32
products of the stored values (JAX's ``preferred_element_type=float32``);
norms compute statistics in float32 and cast back to the input dtype.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def uniform(shape, bound: float, *, generator=None, dtype=torch.float32,
            device="cuda") -> torch.Tensor:
    """U(-bound, bound) drawn in float32 then cast (the JAX init recipe).
    On the ``meta`` device only the shape is built (no draw)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.uniform_(-bound, bound, generator=generator)
    return t.to(dtype)


def normal(shape, *, generator=None, dtype=torch.float32,
           device="cuda") -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.normal_(generator=generator)
    return t.to(dtype)


def init_linear(in_dim: int, out_dim: int, bias: bool = True, *,
                generator=None, dtype=torch.float32, device="cuda",
                scale: Optional[float] = None) -> Params:
    """torch nn.Linear default init U(-1/sqrt(in), 1/sqrt(in)), stored
    ``[in, out]`` like the JAX package."""
    scale = 1.0 / math.sqrt(in_dim) if scale is None else scale
    kw = dict(generator=generator, dtype=dtype, device=device)
    p: Params = {"kernel": uniform((in_dim, out_dim), scale, **kw)}
    if bias:
        p["bias"] = uniform((out_dim,), scale, **kw)
    return p


def init_layer_norm(dim: int, *, dtype=torch.float32, device="cuda") -> Params:
    return {
        "weight": torch.ones(dim, dtype=dtype, device=device),
        "bias": torch.zeros(dim, dtype=dtype, device=device),
    }


def init_rms_norm(dim: int, *, dtype=torch.float32, device="cuda") -> Params:
    return {"weight": torch.ones(dim, dtype=dtype, device=device)}


def qdot(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel as a float32 result; ``{kernel_q, kernel_scale}`` linears
    are dequantised first (JAX ``qdot``: the off-hot-path int8 form used by
    the encoders and VAE, never the DiT kernels)."""
    if "kernel_q" in p:
        w = (p["kernel_q"].float() * p["kernel_scale"].float()).to(x.dtype)
    else:
        w = p["kernel"]
    return torch.matmul(x.float(), w.float())


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = qdot(p, x)
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with float32 statistics; affine optional (adaLN uses none)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def stack_trees(trees: Sequence[Params]) -> Params:
    """Stack same-structured trees on a new leading axis (block stacks)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees))


def init_mlp(dims: Sequence[int], bias: bool = True, *, generator=None,
             dtype=torch.float32, device="cuda") -> Params:
    """A stack of linears dims[0] -> dims[1] -> ... as ``linear_<i>``; the
    caller's apply function puts the activations between them."""
    return {f"linear_{i}": init_linear(dims[i], dims[i + 1], bias,
                                       generator=generator, dtype=dtype,
                                       device=device)
            for i in range(len(dims) - 1)}


def tree_leaves(tree) -> list:
    """The tensor leaves of a dict/list tree, in order; None leaves (as
    `train.step.partition` leaves them) are skipped."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def count_params(params: Params) -> int:
    """The number of elements over every leaf of a tree."""
    return sum(x.numel() for x in tree_leaves(params))


def tree_cast(params: Params, dtype: torch.dtype) -> Params:
    """Cast every floating-point leaf to ``dtype`` (integer leaves, such as
    int8 codes, are kept)."""
    if isinstance(params, dict):
        return {k: tree_cast(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [tree_cast(v, dtype) for v in params]
    if params is None or not params.is_floating_point():
        return params
    return params.to(dtype)
