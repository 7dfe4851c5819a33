"""Tensor-parallel forms of the stacked int8 quant-matmuls (counterpart of
``loongx_tpu/parallel/tp_quant.py``).

Each rank runs the port's stacked kernels (``ops/quant_matmul.py``) on the
weight shard it holds, with the Megatron column / row split of
`parallel.mesh`'s rules:

  col  -- W split on the output axis (qkv, ff.in, proj_mlp): x arrives
          whole, the rank computes its N slice, the output stays split
          into the next op.  Bias, gelu and the LN + adaLN prologue (whole
          K rows on every rank) run in the kernel.
  row  -- W split on the input axis (to_out, ff.out, proj_out): x arrives
          split from the preceding col op, the rank computes a partial
          product (no bias, no epilogue), rounded to bf16 (the kernel's
          output) and widened to float32 as the JAX package rounds it, one
          ``all_reduce`` over the tensor group sums the partials, then the
          bias and the gate + residual apply in float32 and the result is
          bf16.
  repl -- W whole on every rank (modulation, embedders): the whole kernel.

`tp_quant_matmul_stacked` is forward only, as in the JAX package.  A rank
never splits one sequence's rows: the prologue and the gate epilogue place
rows in their img | cond segments by the global ``seg_boundary``.

Training (grad enabled) takes the Megatron pair of collectives as autograd
Functions: `copy_to_tensor` (identity forward; the backward sums dx over
the tensor group, since a column split's dx holds only its columns' part)
on the input of the column splits, and `reduce_from_tensor` (the sum
forward; identity backward, the summed output's gradient being whole on
every rank) on the output of the row splits.  Between them the model runs
the port's kernel Functions (``quant_matmul_stacked_vjp``,
``quant_linear_gelu_stacked``) on the rank's shard, as one process runs
them on the whole weight: dx comes from the transposed kernel on the
shard, summed over the group for a column split, kept local for a row
split.  Every sum is taken in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from loongx_tpu_torch.ops import quant_matmul as qmm
from loongx_tpu_torch.parallel.mesh import current_tp


def all_reduce(y: torch.Tensor, mesh, axis: str = "tensor") -> torch.Tensor:
    """Sum ``y`` over the ranks of ``mesh``'s ``axis`` in place; returns
    it."""
    dist.all_reduce(y, group=mesh.group(axis))
    return y


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        total = dx.to(torch.float32, copy=True)
        dist.all_reduce(total, group=ctx.group)
        return total.to(dx.dtype), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        total = y.clone()  # the graph's y is not summed in place
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_tensor(x: torch.Tensor) -> torch.Tensor:
    """The input of a column split under the active tensor context with
    grad enabled: x itself in the forward, its gradient summed over the
    tensor group in float32 in the backward.  ``x`` as it is outside
    training under a tensor axis, and for an ``x`` that is already such a
    copy (a second copy would sum the summed gradient again), so that
    several column splits can share one copy and one sum."""
    tp = current_tp()
    if (tp is None or not torch.is_grad_enabled()
            or getattr(x, "_tensor_copy", False)):
        return x
    out = _CopyToTensor.apply(x, tp[0].group(tp[1]))
    out._tensor_copy = True
    return out


def reduce_from_tensor(y: torch.Tensor, mesh, axis: str = "tensor"
                       ) -> torch.Tensor:
    """The sum of ``y`` over ``mesh``'s ``axis``: with grad enabled a new
    tensor whose gradient passes to each rank's ``y`` whole, else `all_reduce`
    in place (serving)."""
    if not torch.is_grad_enabled():
        return all_reduce(y, mesh, axis)
    return _ReduceFromTensor.apply(y, mesh.group(axis))


def tp_quant_matmul_stacked(kind: str, x2: torch.Tensor, w_q3: torch.Tensor,
                            scale3: torch.Tensor, blk: int,
                            bias2: Optional[torch.Tensor] = None,
                            activation: Optional[str] = None,
                            ab: Optional[torch.Tensor] = None,
                            seg_boundary: int = 0,
                            resid: Optional[torch.Tensor] = None,
                            gate: Optional[torch.Tensor] = None,
                            w8a8: bool = False) -> torch.Tensor:
    """This rank's stacked quant matmul under the active tensor context.

    x2 [M, K] (row: K split), w_q3 [NB, K, N] int8 and scale3 [NB, 1, N]
    (split per ``kind``), bias2 [NB, N] (col: split), ``ab`` [8, K] the
    prologue (col / repl), ``resid`` [M, N] + ``gate`` [8, N] the epilogue
    (row).  Returns [M, N]: this rank's N slice for "col", the whole sum
    for "row" / "repl"."""
    tp = current_tp()
    if tp is None:
        raise RuntimeError("tp_quant_matmul_stacked outside a tensor context")
    if kind not in ("col", "row", "repl"):
        raise ValueError(f"unknown tensor-parallel kind {kind!r}")
    if kind == "row" and (ab is not None or activation is not None):
        raise ValueError("a row split has no prologue or activation: the "
                         "LN prologue needs whole feature rows")
    if kind != "row" and (resid is not None or gate is not None):
        raise ValueError(f"the gate epilogue needs the summed product, not a "
                         f"{kind!r} split")
    nb, _, n = w_q3.shape
    scale3 = scale3.reshape(nb, 1, n)
    if kind == "row":
        y = qmm.quant_matmul_stacked(x2, w_q3, scale3, blk, w8a8=w8a8)
        y = y.to(torch.bfloat16).float()  # the kernel's output on the card
        all_reduce(y, *tp)
        if bias2 is not None:
            y = y + bias2[blk].float()[None, :]
        if gate is not None:
            rows = torch.arange(y.shape[0], device=y.device)[:, None]
            g = torch.where(rows >= seg_boundary, gate[1:2].float(),
                            gate[0:1].float())
            y = resid.float() + g * y
        return y.to(torch.bfloat16)
    bias3 = None if bias2 is None else bias2.float().reshape(nb, 1, n)
    return qmm.quant_matmul_stacked(x2, w_q3, scale3, blk, bias3=bias3,
                                    activation=activation, w8a8=w8a8, ab=ab,
                                    seg_boundary=seg_boundary)


def tp_quant_qkv_stacked(x2: torch.Tensor, w_q4: torch.Tensor,
                         scale4: torch.Tensor, bias4: Optional[torch.Tensor],
                         norm_w: torch.Tensor, blk: int, head_dim: int,
                         ab: Optional[torch.Tensor] = None,
                         seg_boundary: int = 0, w8a8: bool = False):
    """The fused-qkv projection on the TP layout (ops.quant.
    fuse_qkv_projections(tp_layout=True)): w_q4 [NB, K, 3, H] with the
    head axis H split, scale4 [NB, 1, 3, H], bias4 [NB, 3, H], norm_w
    [3, H] of the rank's heads.  The rank's stack, read as the flat fused
    [NB, K, 3 * H] layout (a view), is a complete fused qkv for its heads
    and runs the one kernel (``EPI_QKV``: per-head RMS norm in its
    epilogue).  Returns (q, k, v), each [M, H] of the rank's heads; no
    collective.  Whole stacks (one rank) take the same path."""
    nb, k, _, h = w_q4.shape
    bias3 = (torch.zeros(nb, 1, 3 * h, dtype=torch.float32,
                         device=w_q4.device) if bias4 is None
             else bias4.float().reshape(nb, 1, 3 * h))
    return qmm.quant_qkv_stacked(
        x2, w_q4.reshape(nb, k, 3 * h), scale4.reshape(nb, 1, 3 * h), bias3,
        norm_w, blk, head_dim, w8a8=w8a8, ab=ab, seg_boundary=seg_boundary)
