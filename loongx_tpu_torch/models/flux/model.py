"""FLUX.1-style diffusion transformer with the condition-token stream.

Counterpart of ``loongx_tpu/models/flux/model.py``: dual-stream ("double")
blocks with one attention over [txt | img | cond], single-stream blocks over
[txt + img] (+ cond), per-head RMS q/k norms, 3-axis RoPE, adaLN-zero
modulation, condition tokens modulated at the fixed condition timestep c_t,
and the union / no_union / independent / c_factor attention modes.

Params are the JAX package's tree (bridged by ``utils/bridge.py`` or built
by `init_flux_params`): block params stacked ``[NB, ...]``.  The forward
loops over the blocks in Python; int8 linears of a block stay whole
``[NB, K, N]`` stacks and reach the quant-matmul kernels with the block
index (``_blk``), every other leaf is indexed per block.  Routing:

  * int8 block linears -> ``quant_matmul_stacked`` (fused bias + gelu for
    the MLP-in projections) and the fused qkv -> ``quant_qkv_stacked``;
  * int8 flat linears (embedders, norm_out, proj_out) -> ``quant_matmul``
    (fused bias + gelu where `linear_gelu` has no active LoRA);
  * the W8A8 GEMM on wgmma reads its weight K-major: its first launch
    makes the leaf K-major in place, a launch of any other kernel (or the
    dequantised product under a tensor context) makes it [K, N] again
    (``ops.w8a8_layout``: the same logical tensor, the strides the marker);
  * every int8 linear keeps the kernel's bf16 output: the bias rides in
    its epilogue, an active LoRA adds ((x A) * scale * mask) B to it as one
    rank-r update (`_int8_linear`);
  * float linears -> a float32 ``torch.matmul``;
  * attention -> ``flash_attention`` (bshd, RoPE in the kernel).

With grad enabled the int8 linears go through the differentiable
counterparts (``quant_matmul_vjp``, ``quant_matmul_stacked_vjp``,
``quant_linear_gelu_stacked``, ``quant_linear_gelu``), whose backward runs
the transposed kernels; ``flash_attention`` is differentiable by itself.
``flux_forward(remat=True)`` checkpoints each block (non-reentrant
``torch.utils.checkpoint``), as the JAX package wraps each scan body in
``jax.checkpoint``: the backward re-runs a block's forward kernels, each
re-run the span ``train.recompute`` (`utils.profiling`).

``w8a8`` selects the MAC mode of every int8 linear (the serving knob the
JAX package reads from LOONGX_W8A8); ``int8_attn`` the int8 QK^T mode of
the attention (LOONGX_INT8_ATTN there; off under autograd).

``fuse_ln`` / ``fuse_gate`` (LOONGX_FUSE_LN / LOONGX_FUSE_GATE there, off
by default in both) fold the block's elementwise work into the int8
kernels: the layer norm + per-segment adaLN affine becomes the prologue of
the fused qkv and the MLP-in projections (`ln_mod_linear`, ``_qkv(...,
ln_mod=)``), the adaLN-zero gate + residual add the epilogue of to_out,
ff.out and proj_out (`gate_res_linear`).  They route exactly where the
JAX package's `_elementwise_fusable` / ``ln_in_kernel`` route: the flag is
on, the weight is an int8 stack with ``_blk``, no active LoRA leaf sits on
the linear and the batch is 1; everywhere else the same math is composed
around the matmul (``add_cond_attn``'s cross-segment add always is).  With
grad enabled the fused forms go through `quant_ln_mod_linear_stacked` /
`quant_gate_res_linear_stacked`.

Under a tensor context (``parallel.mesh.mesh_context`` / ``tp_context``,
tensor extent > 1) the params are this rank's shard
(`parallel.mesh.shard_params`) and every call site names its layer's split
(``tp_kind``), as the JAX package's does: q/k/v, ff.in and proj_mlp
"col" (the output stays split: the rank's heads and MLP columns), to_out,
to_add_out, ff.out and the single blocks' proj_out "row" (one
``all_reduce`` over the tensor group), the rest whole on every rank.  The
stacked int8 linears run `parallel.tp_quant`'s forms of the kernels, the
flash attention the rank's heads (no collective); a rank never splits a
sequence's rows.  With grad enabled (training) every split goes through
the autograd forms: a column split's input through `copy_to_tensor` (one
copy shared by the linears that read the same input: its backward sums dx
over the group once), a row split's sum through `reduce_from_tensor`, the
stacked int8 linears through the kernel Functions on the shard, as one
process runs them, LoRA-active ones included; the flash attention runs its
autograd Function on the rank's heads.  The fused elementwise
forms and a fused qkv are refused there (they are forward only).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from loongx_tpu_torch.ops import cuda_build, w8a8_layout
from loongx_tpu_torch.ops import flash_attention as fa
from loongx_tpu_torch.ops import quant_matmul as qmm
from loongx_tpu_torch.ops.nn import (
    Params, gelu_tanh, init_linear, init_rms_norm, layer_norm, rms_norm, silu,
    stack_trees,
)
from loongx_tpu_torch.ops.rope import rope_embed
from loongx_tpu_torch.parallel.mesh import (
    current_tp, proj_out_rows, tensor_extent,
)
from loongx_tpu_torch.parallel.tp_quant import (
    copy_to_tensor, reduce_from_tensor, tp_quant_matmul_stacked,
    tp_quant_qkv_stacked,
)
from loongx_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    num_heads: int = 24
    head_dim: int = 128
    num_double_blocks: int = 19
    num_single_blocks: int = 38
    joint_dim: int = 4096
    pooled_dim: int = 768
    guidance_embeds: bool = True
    axes_dims: Tuple[int, ...] = (16, 56, 56)
    theta: float = 10000.0
    mlp_ratio: int = 4
    time_embed_channels: int = 256

    @property
    def hidden(self) -> int:
        return self.num_heads * self.head_dim

    @staticmethod
    def flux_dev() -> "FluxConfig":
        return FluxConfig()

    @staticmethod
    def flux_schnell() -> "FluxConfig":
        return FluxConfig(guidance_embeds=False)

    @staticmethod
    def tiny(guidance: bool = True) -> "FluxConfig":
        """Same topology, tiny dims (tests)."""
        return FluxConfig(
            in_channels=16, num_heads=2, head_dim=32, num_double_blocks=2,
            num_single_blocks=2, joint_dim=32, pooled_dim=16,
            guidance_embeds=guidance, axes_dims=(8, 12, 12),
        )


# ---------------------------------------------------------------------------
# Param init (random; the layout of the JAX package's init_flux_params)
# ---------------------------------------------------------------------------


def _init_attn(cfg: FluxConfig, dual: bool, kw) -> Params:
    h = cfg.hidden
    norm_kw = dict(dtype=kw["dtype"], device=kw["device"])
    p: Params = {
        "to_q": init_linear(h, h, **kw),
        "to_k": init_linear(h, h, **kw),
        "to_v": init_linear(h, h, **kw),
        "norm_q": init_rms_norm(cfg.head_dim, **norm_kw),
        "norm_k": init_rms_norm(cfg.head_dim, **norm_kw),
    }
    if dual:
        p.update({
            "add_q_proj": init_linear(h, h, **kw),
            "add_k_proj": init_linear(h, h, **kw),
            "add_v_proj": init_linear(h, h, **kw),
            "norm_added_q": init_rms_norm(cfg.head_dim, **norm_kw),
            "norm_added_k": init_rms_norm(cfg.head_dim, **norm_kw),
            "to_out": init_linear(h, h, **kw),
            "to_add_out": init_linear(h, h, **kw),
        })
    return p


def init_flux_params(cfg: FluxConfig, *, generator=None, dtype=torch.bfloat16,
                     device="cuda") -> Params:
    """Random params in the JAX package's layout.  On the ``meta`` device
    only shapes exist (for `ops.quant.random_quantized_like`)."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    h, tc, mlp = cfg.hidden, cfg.time_embed_channels, cfg.mlp_ratio * cfg.hidden

    def double():
        return {
            "norm1": {"linear": init_linear(h, 6 * h, **kw)},
            "norm1_context": {"linear": init_linear(h, 6 * h, **kw)},
            "attn": _init_attn(cfg, True, kw),
            "ff": {"in": init_linear(h, mlp, **kw),
                   "out": init_linear(mlp, h, **kw)},
            "ff_context": {"in": init_linear(h, mlp, **kw),
                           "out": init_linear(mlp, h, **kw)},
        }

    def single():
        return {
            "norm": {"linear": init_linear(h, 3 * h, **kw)},
            "attn": _init_attn(cfg, False, kw),
            "proj_mlp": init_linear(h, mlp, **kw),
            "proj_out": init_linear(h + mlp, h, **kw),
        }

    params: Params = {
        "x_embedder": init_linear(cfg.in_channels, h, **kw),
        "context_embedder": init_linear(cfg.joint_dim, h, **kw),
        "time_in": {"in_layer": init_linear(tc, h, **kw),
                    "out_layer": init_linear(h, h, **kw)},
        "vector_in": {"in_layer": init_linear(cfg.pooled_dim, h, **kw),
                      "out_layer": init_linear(h, h, **kw)},
        "double_blocks": stack_trees(
            [double() for _ in range(cfg.num_double_blocks)]),
        "single_blocks": stack_trees(
            [single() for _ in range(cfg.num_single_blocks)]),
        "norm_out": {"linear": init_linear(h, 2 * h, **kw)},
        "proj_out": init_linear(h, cfg.in_channels, **kw),
    }
    if cfg.guidance_embeds:
        params["guidance_in"] = {"in_layer": init_linear(tc, h, **kw),
                                 "out_layer": init_linear(h, h, **kw)}
    return params


# ---------------------------------------------------------------------------
# Linears
# ---------------------------------------------------------------------------


def _block_view(tree, blk: int):
    """Block ``blk`` of a stacked block tree: int8 linears keep their whole
    kernel_q / kernel_scale / bias stacks, tagged ``_blk``; every other leaf
    is indexed (a view)."""
    if isinstance(tree, dict):
        if "kernel_q" in tree:
            out = {k: (v if k in ("kernel_q", "kernel_scale", "bias") else v[blk])
                   for k, v in tree.items()}
            out["_blk"] = blk
            return out
        return {k: _block_view(v, blk) for k, v in tree.items()}
    return tree[blk]


def _bias3(p: Params, n: int) -> torch.Tensor:
    """float32 [NB, 1, N] bias operand of a stacked linear (zeros if none)."""
    nb = p["kernel_q"].shape[0]
    if "bias" in p:
        return p["bias"].float().reshape(nb, 1, n)
    return torch.zeros(nb, 1, n, dtype=torch.float32,
                       device=p["kernel_q"].device)


def _lora_delta(p: Params, x: torch.Tensor, y_width: int, tp, tp_kind):
    """(xA)B * lora_scale in float32 (the widened routes of `linear`);
    under a tensor context (``tp`` = (mesh, axis)) the whole A / B leaves
    meet the rank's shard: a col split takes B's columns of its output
    slice, a row split sums x_local A[its rows] over the tensor group (its
    rows by `proj_out_rows` for the single blocks' [attention | MLP]
    concat, "row_cat")."""
    a, b = p["lora_a"].float(), p["lora_b"].float()
    if tp is not None and tp_kind == "col":
        b = b.narrow(-1, tp[0].index(tp[1]) * y_width, y_width)
    if tp is not None and tp_kind in ("row", "row_cat"):
        mesh, axis = tp
        parts, idx, k_l = mesh.shape[axis], mesh.index(axis), x.shape[-1]
        if tp_kind == "row_cat":
            rows = proj_out_rows(a.shape[-2], b.shape[-1], parts, idx)
            a = a.index_select(-2, rows.to(a.device))
        else:
            a = a.narrow(-2, idx * k_l, k_l)
        xa = reduce_from_tensor(torch.matmul(x.float(), a), mesh,
                                axis).to(x.dtype)
    else:
        xa = torch.matmul(x.float(), a).to(x.dtype)
    return torch.matmul(xa.float(), b) * p["lora_scale"]


def _count(route: str) -> None:
    """One int8 call of `linear` / `linear_gelu` by route (keys with ":",
    which the launch counts of `utils.profiling` leave out): ``bf16_out``
    returns the kernel's output with no float32 [M, N] tensor,
    ``fp32_out`` widens it (float32 activations, a row split's sum, the
    dequantised serving product), ``lora_update`` is a rank-r update."""
    cuda_build.LAUNCHES[f"int8_linear:{route}"] += 1


def _int8_linear(p: Params, x2: torch.Tensor, lead, active_lora: bool,
                 lora_mask: Optional[torch.Tensor], w8a8: bool, tp,
                 tp_kind: Optional[str]) -> torch.Tensor:
    """An int8 linear whose output stays the kernel's: with bf16
    activations (the kernels write bf16, so their rounding is the result's)
    the bias rides in the kernel's float32 epilogue and an active LoRA is
    one rank-r update of that output (``qmm.lora_factor`` /
    ``qmm.lora_update``; in training both inside the kernel's autograd
    Function).  Wider activations widen the kernel's output and add the
    bias in float32 after the update, as the JAX package does.  lora_scale
    and the 0/1 row mask fold into the [M, r] factor; a column split takes
    B's columns of its output slice."""
    n = p["kernel_q"].shape[-1]
    blk = p.get("_blk")
    fold = "bias" in p and x2.dtype == torch.bfloat16
    if blk is not None:
        scale = p["kernel_scale"].reshape(p["kernel_q"].shape[0], 1, n)
        bias = _bias3(p, n) if fold else None
    else:
        scale = p["kernel_scale"].reshape(1, n)
        bias = p["bias"].float().reshape(1, n) if fold else None
    lora = None
    if active_lora:
        b = p["lora_b"]
        if tp is not None and tp_kind == "col":
            b = b.narrow(-1, tp[0].index(tp[1]) * n, n)
        ms = p["lora_scale"].float()
        if lora_mask is not None:
            ms = torch.broadcast_to(lora_mask.float() * ms,
                                    (*lead, 1)).reshape(-1, 1)
        lora = (p["lora_a"], b, ms)
        _count("lora_update")
    _count("bf16_out" if x2.dtype == torch.bfloat16 else "fp32_out")
    if torch.is_grad_enabled():
        if blk is None:
            y = qmm.quant_matmul_vjp(x2, p["kernel_q"], scale, bias=bias,
                                     lora=lora, w8a8=w8a8)
        else:
            y = qmm.quant_matmul_stacked_vjp(x2, p["kernel_q"], scale, blk,
                                             bias3=bias, lora=lora, w8a8=w8a8)
    else:
        if blk is None:
            y = qmm.quant_matmul(x2, p["kernel_q"], scale, bias=bias,
                                 w8a8=w8a8)
        else:
            y = qmm.quant_matmul_stacked(x2, p["kernel_q"], scale, blk,
                                         bias3=bias, w8a8=w8a8)
        if lora is not None:
            y = qmm.lora_update(y.to(x2.dtype),
                                qmm.lora_factor(x2, lora[0], lora[2]), lora[1])
    if "bias" in p and not fold:
        b = p["bias"] if blk is None else p["bias"][blk]
        y = y.to(x2.dtype) + b.float()
    return y


def linear(p: Params, x: torch.Tensor, use_lora: bool = True,
           lora_mask: Optional[torch.Tensor] = None,
           w8a8: bool = False, tp_kind: Optional[str] = None) -> torch.Tensor:
    """y = xW + b [+ (xA)B * lora_scale (* lora_mask)] in x's dtype.

    ``tp_kind`` names the layer's split under a tensor context ("col",
    "row", "row_cat" for the single blocks' proj_out over the [attention |
    MLP] concat, None: whole on every rank).  An int8 linear returns its
    kernel's output (`_int8_linear`: with bf16 activations the bias in the
    epilogue, an active LoRA one rank-r update, no float32 [M, N] tensor),
    counted as ``int8_linear:bf16_out`` (and ``int8_linear:lora_update``)
    in `cuda_build.LAUNCHES`.  Serving (grad disabled) under a tensor context:
    a stacked int8 linear without an active LoRA runs
    `tp_quant_matmul_stacked`; one with an active LoRA a dequantised
    product, as the JAX package's.  Training (grad enabled): a column
    split's x through `copy_to_tensor`, every int8 linear through the
    one-process kernel Functions on the shard.  A row split sums its
    partial product over the tensor group (`reduce_from_tensor`) in float32
    before the LoRA delta and the bias.  The routes that widen the product
    to float32 (those two, wider activations and the float ``kernel``)
    count an int8 call as ``int8_linear:fp32_out``."""
    lead, k = x.shape[:-1], x.shape[-1]
    tp = current_tp()
    if tp_kind == "col":
        x = copy_to_tensor(x)  # x itself but in training under a tensor axis
    x2 = x.reshape(-1, k)
    active_lora = use_lora and "lora_a" in p
    stacked = "kernel_q" in p and "_blk" in p
    serving_tp = tp is not None and not torch.is_grad_enabled()
    row_split = tp is not None and tp_kind in ("row", "row_cat")
    if serving_tp and stacked and not active_lora:
        kind = "row" if tp_kind == "row_cat" else tp_kind or "repl"
        nb = p["kernel_q"].shape[0]
        y = tp_quant_matmul_stacked(
            kind, x2, p["kernel_q"], p["kernel_scale"].reshape(nb, 1, -1),
            p["_blk"], bias2=p.get("bias"), w8a8=w8a8)
        _count("fp32_out" if kind == "row" else "bf16_out")
        return y.reshape(*lead, -1).to(x.dtype)
    if "kernel_q" in p and not (serving_tp and stacked) and not row_split:
        y = _int8_linear(p, x2, lead, active_lora, lora_mask, w8a8, tp,
                         tp_kind)
        return y.reshape(*lead, -1).to(x.dtype)
    if serving_tp and stacked:
        blk = p["_blk"]
        w8a8_layout.to_kn(p["kernel_q"], 1)  # the [K, N] product, as stored
        w = (p["kernel_q"][blk].float()
             * p["kernel_scale"][blk].float()).to(x.dtype)
        y = torch.matmul(x2.float(), w.float())
    elif "kernel_q" in p:  # a row split: its partial products summed in fp32
        n = p["kernel_q"].shape[-1]
        grad = torch.is_grad_enabled()
        if stacked:
            nb = p["kernel_q"].shape[0]
            mm = qmm.quant_matmul_stacked_vjp if grad else qmm.quant_matmul_stacked
            y = mm(x2, p["kernel_q"], p["kernel_scale"].reshape(nb, 1, n),
                   p["_blk"], w8a8=w8a8)
        else:
            mm = qmm.quant_matmul_vjp if grad else qmm.quant_matmul
            y = mm(x2, p["kernel_q"], p["kernel_scale"].reshape(1, n), w8a8=w8a8)
        y = y.float()
    else:
        y = torch.matmul(x2.float(), p["kernel"].float())
    if "kernel_q" in p:
        _count("fp32_out")
    if row_split:
        y = reduce_from_tensor(y, *tp)
    y = y.reshape(*lead, -1)
    if active_lora:
        delta = _lora_delta(p, x, y.shape[-1], tp, tp_kind)
        if lora_mask is not None:
            delta = delta * lora_mask
        y = y + delta
    if "bias" in p:
        b = p["bias"][p["_blk"]] if "_blk" in p else p["bias"]
        y = y + b.float()
    return y.to(x.dtype)


def linear_gelu(p: Params, x: torch.Tensor, use_lora: bool = True,
                lora_mask: Optional[torch.Tensor] = None,
                w8a8: bool = False,
                tp_kind: Optional[str] = None) -> torch.Tensor:
    """gelu_tanh(linear(p, x)); int8 linears without an active LoRA fuse
    the bias + gelu into the quant-matmul epilogue (served under a tensor
    context, the stacked ones through `tp_quant_matmul_stacked`, x as bf16,
    as the JAX package's; in training a column split's x through
    `copy_to_tensor`, then the fused bias + gelu Function on the shard).
    With an active LoRA the gelu is one pass over `linear`'s output (the
    kernel's, with the rank-r update added)."""
    if "kernel_q" in p and not (use_lora and "lora_a" in p):
        lead, k = x.shape[:-1], x.shape[-1]
        if tp_kind == "col":
            x = copy_to_tensor(x)
        x2 = x.reshape(-1, k)
        tp = current_tp()
        _count("bf16_out" if x.dtype == torch.bfloat16 else "fp32_out")
        if tp is not None and "_blk" in p and not torch.is_grad_enabled():
            nb = p["kernel_q"].shape[0]
            y = tp_quant_matmul_stacked(
                tp_kind or "repl", x2.to(torch.bfloat16), p["kernel_q"],
                p["kernel_scale"].reshape(nb, 1, -1), p["_blk"],
                bias2=p.get("bias"), activation="gelu_tanh", w8a8=w8a8)
            return y.reshape(*lead, -1).to(x.dtype)
        grad = torch.is_grad_enabled()
        n = p["kernel_q"].shape[-1]
        if "_blk" in p:
            nb = p["kernel_q"].shape[0]
            scale3 = p["kernel_scale"].reshape(nb, 1, n)
            if grad:
                y = qmm.quant_linear_gelu_stacked(
                    x2, p["kernel_q"], scale3, _bias3(p, n), p["_blk"], w8a8=w8a8)
            else:
                y = qmm.quant_matmul_stacked(
                    x2, p["kernel_q"], scale3, p["_blk"], bias3=_bias3(p, n),
                    activation="gelu_tanh", w8a8=w8a8)
        else:
            scale = p["kernel_scale"].reshape(1, n)
            bias = (p["bias"].float().reshape(1, n) if "bias" in p else
                    torch.zeros(1, n, dtype=torch.float32, device=x.device))
            if grad:
                y = qmm.quant_linear_gelu(x2, p["kernel_q"], scale, bias,
                                          w8a8=w8a8)
            else:
                y = qmm.quant_matmul(x2, p["kernel_q"], scale, bias=bias,
                                     activation="gelu_tanh", w8a8=w8a8)
        return y.reshape(*lead, n).to(x.dtype)
    return gelu_tanh(linear(p, x, use_lora, lora_mask, w8a8, tp_kind))


def _elementwise_fusable(p: Params, x: torch.Tensor, use_lora: bool,
                         flag: bool) -> bool:
    """Can the LN prologue / gate epilogue ride into this linear's kernel
    (the JAX package's `_elementwise_fusable`)?"""
    return (flag and "kernel_q" in p and "_blk" in p
            and p["kernel_q"].ndim == 3 and not (use_lora and "lora_a" in p)
            and x.shape[0] == 1)


def _refuse_tp_training(what: str) -> None:
    """Refuse a forward-only form under a tensor axis with grad enabled."""
    if current_tp() is not None and torch.is_grad_enabled():
        raise NotImplementedError(
            f"{what} under a tensor axis with grad enabled is not ported "
            "(ROADMAP Queue 1 item 13: the fused forms in training under a "
            "tensor axis); train under a tensor axis with fuse_ln=False, "
            "fuse_gate=False and q/k/v unfused (the training layout)")


def _mk_ab(a_main, b_main, a_cond, b_cond, k: int) -> torch.Tensor:
    """The kernels' [8, K] float32 ab operand: rows a_main / b_main / a_cond
    / b_cond (batch row 0); the cond rows repeat the main affine when there
    is no cond segment."""
    if a_cond is None:
        a_cond, b_cond = a_main, b_main
    return _rows8([a_main, b_main, a_cond, b_cond], k)


def _rows8(rows, width: int) -> torch.Tensor:
    """[8, width] float32: batch row 0 of each given [B, width] tensor, then
    zero rows (the kernels' ab / gate operand layout)."""
    top = torch.stack([r[0].float() for r in rows])
    return torch.cat([top, top.new_zeros(8 - len(rows), width)])


def ln_mod_linear(p: Params, x: torch.Tensor, ln_mod,
                  activation: Optional[str] = None, use_lora: bool = True,
                  lora_mask: Optional[torch.Tensor] = None, w8a8: bool = False,
                  fuse_ln: bool = False) -> torch.Tensor:
    """(layer_norm(x) * a_seg + b_seg) -> linear (+ gelu_tanh).

    ln_mod = (a_main, b_main, a_cond | None, b_cond | None, boundary); x is
    the raw fused [main | cond] stream [B, S, K]."""
    if activation not in (None, "gelu_tanh"):
        raise ValueError(f"unknown fused activation {activation!r}")
    if _elementwise_fusable(p, x, use_lora, fuse_ln):
        a_m, b_m, a_c, b_c, boundary = ln_mod
        b, s, k = x.shape
        nb, _, n = p["kernel_q"].shape
        x2, wq, blk = x.reshape(s, k), p["kernel_q"], p["_blk"]
        sc, bias3 = p["kernel_scale"].reshape(nb, 1, n), _bias3(p, n)
        ab = _mk_ab(a_m, b_m, a_c, b_c, k)
        _refuse_tp_training("fuse_ln")
        if current_tp() is not None:
            y = tp_quant_matmul_stacked(
                "col", x2, wq, sc, blk, bias2=p.get("bias"),
                activation=activation, ab=ab, seg_boundary=boundary,
                w8a8=w8a8)
        elif torch.is_grad_enabled():
            y = qmm.quant_ln_mod_linear_stacked(
                x2, wq, sc, bias3, ab, blk, seg_boundary=boundary,
                activation=activation, w8a8=w8a8)
        else:
            y = qmm.quant_matmul_stacked(
                x2, wq, sc, blk, bias3=bias3, activation=activation, w8a8=w8a8,
                ab=ab, seg_boundary=boundary)
        return y.reshape(b, s, n).to(x.dtype)
    nx = _ln_mod(x, ln_mod)
    if activation == "gelu_tanh":
        return linear_gelu(p, nx, use_lora, lora_mask, w8a8, "col")
    return linear(p, nx, use_lora, lora_mask, w8a8, "col")


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, flip_sin_to_cos (t already scaled by 1000)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _time_mlp(p: Params, emb: torch.Tensor, dtype, w8a8: bool):
    h = linear(p["in_layer"], emb.to(dtype), use_lora=False, w8a8=w8a8)
    return linear(p["out_layer"], silu(h), use_lora=False, w8a8=w8a8)


def combined_timestep_embed(params: Params, cfg: FluxConfig,
                            timestep: torch.Tensor, pooled: torch.Tensor,
                            guidance: Optional[torch.Tensor],
                            w8a8: bool = False) -> torch.Tensor:
    """temb = MLP(sin(t)) [+ MLP(sin(g))] + MLP(pooled)."""
    dtype = pooled.dtype
    t_emb = _time_mlp(params["time_in"],
                      timestep_embedding(timestep, cfg.time_embed_channels),
                      dtype, w8a8)
    if cfg.guidance_embeds:
        if guidance is None:
            raise ValueError("guidance_embeds=True requires guidance")
        t_emb = t_emb + _time_mlp(
            params["guidance_in"],
            timestep_embedding(guidance, cfg.time_embed_channels), dtype, w8a8)
    pool_h = linear(params["vector_in"]["in_layer"], pooled, use_lora=False,
                    w8a8=w8a8)
    return t_emb + linear(params["vector_in"]["out_layer"], silu(pool_h),
                          use_lora=False, w8a8=w8a8)


# ---------------------------------------------------------------------------
# Block primitives
# ---------------------------------------------------------------------------


def _fused_qkv_stacked(p: Params, nq, nk, x: torch.Tensor, num_heads: int,
                       w8a8: bool, ln_mod=None):
    """Stacked fused-qkv projection: one kernel does the matmul, the q/k/v
    split into planes and the per-head RMS of q and k; ``ln_mod`` also
    fuses the layer norm + adaLN affine into its x load (x is then the raw
    stream).  The TP layout ([NB, K, 3, H], `tp_quant_qkv_stacked`) holds
    the rank's ``num_heads`` heads."""
    _refuse_tp_training("a fused qkv projection")
    b, s, kdim = x.shape
    tp4 = p["kernel_q"].ndim == 4
    nb = p["kernel_q"].shape[0]
    n3 = p["kernel_q"].shape[-1] * (3 if tp4 else 1)
    h = n3 // 3
    hd = h // num_heads
    norm_w = torch.stack([
        nq["weight"].float().repeat(num_heads),
        nk["weight"].float().repeat(num_heads),
        torch.ones(h, dtype=torch.float32, device=x.device),
    ])
    ab, boundary = None, 0
    if ln_mod is not None:
        a_m, b_m, a_c, b_c, boundary = ln_mod
        ab = _mk_ab(a_m, b_m, a_c, b_c, kdim)
    if tp4:
        q, k, v = tp_quant_qkv_stacked(
            x.reshape(-1, kdim), p["kernel_q"], p["kernel_scale"], p.get("bias"),
            norm_w, p["_blk"], hd, ab=ab, seg_boundary=boundary, w8a8=w8a8)
    else:
        q, k, v = qmm.quant_qkv_stacked(
            x.reshape(-1, kdim), p["kernel_q"],
            p["kernel_scale"].reshape(nb, 1, n3), _bias3(p, n3), norm_w,
            p["_blk"], hd, w8a8=w8a8, ab=ab, seg_boundary=boundary)
    shape = (b, s, num_heads, hd)
    return (q.reshape(shape).to(x.dtype), k.reshape(shape).to(x.dtype),
            v.reshape(shape).to(x.dtype))


def _qkv(attn: Params, x: torch.Tensor, num_heads: int, prefix: str = "to",
         use_lora: bool = True, lora_mask: Optional[torch.Tensor] = None,
         w8a8: bool = False, ln_mod=None, fuse_ln: bool = False):
    """Project + split heads + per-head RMS q/k norm -> [B, S, H, Dh] x 3
    (bshd, the projection's own layout).  With ``ln_mod`` x is the raw
    stream: the layer norm + adaLN affine rides into the fused-qkv kernel
    under ``fuse_ln`` at batch 1, else it is applied here."""
    if prefix == "to":
        fused = attn.get("to_qkv")
        nq, nk = attn["norm_q"], attn["norm_k"]
    else:
        fused = attn.get("add_qkv_proj")
        nq, nk = attn["norm_added_q"], attn["norm_added_k"]
    fused_ok = fused is not None and "kernel_q" in fused and "_blk" in fused
    if ln_mod is not None and not (fused_ok and fuse_ln and x.shape[0] == 1):
        x, ln_mod = _ln_mod(x, ln_mod), None
    if fused is not None:
        if fused_ok:
            return _fused_qkv_stacked(fused, nq, nk, x, num_heads, w8a8, ln_mod)
        q, k, v = linear(fused, x, use_lora=False, w8a8=w8a8).chunk(3, dim=-1)
    elif prefix == "to":
        x = copy_to_tensor(x)  # one copy, one dx sum for q, k and v
        q, k, v = (linear(attn[f"to_{n}"], x, use_lora, lora_mask, w8a8, "col")
                   for n in "qkv")
    else:
        x = copy_to_tensor(x)
        q, k, v = (linear(attn[f"add_{n}_proj"], x, False, None, w8a8, "col")
                   for n in "qkv")
    b, s, _ = q.shape
    q, k, v = (t.reshape(b, s, num_heads, -1) for t in (q, k, v))
    return rms_norm(q, nq["weight"]), rms_norm(k, nk["weight"]), v


def _seg_lora(s_img: int, s_cond: int, latent_lora: bool, dtype, device):
    """(use_lora, lora_mask) for a fused [img | cond] stream: LoRA always on
    cond tokens, on image tokens only under latent_lora."""
    if s_cond == 0:
        return latent_lora, None
    if latent_lora:
        return True, None
    mask = torch.cat([torch.zeros(s_img, 1, dtype=dtype, device=device),
                      torch.ones(s_cond, 1, dtype=dtype, device=device)])
    return True, mask


def _mod6(p: Params, temb: torch.Tensor, w8a8: bool):
    return linear(p["linear"], silu(temb), use_lora=False,
                  w8a8=w8a8).chunk(6, dim=-1)


def _mod_pair(p: Params, temb: torch.Tensor, cond_temb: Optional[torch.Tensor],
              latent_lora: bool, n_chunks: int, w8a8: bool):
    """Both modulation matvecs (img at temb, cond at cond_temb) through the
    shared adaLN linear in one matmul."""
    b = temb.shape[0]
    if cond_temb is None:
        mi = linear(p["linear"], silu(temb), use_lora=latent_lora,
                    w8a8=w8a8).chunk(n_chunks, dim=-1)
        return mi, [None] * n_chunks
    both = torch.cat([silu(temb), silu(cond_temb)], dim=0)
    mask = torch.cat([
        torch.full((b, 1), 1.0 if latent_lora else 0.0, dtype=both.dtype,
                   device=both.device),
        torch.ones(b, 1, dtype=both.dtype, device=both.device)])
    mod = linear(p["linear"], both, use_lora=True, lora_mask=mask, w8a8=w8a8)
    return mod[:b].chunk(n_chunks, dim=-1), mod[b:].chunk(n_chunks, dim=-1)


def _seg_affine(x, boundary: int, a_main, b_main, a_cond, b_cond):
    """y = x * a + b with (a, b) per row segment of the fused stream split at
    ``boundary`` (main rows first); the same math at every batch size."""
    if a_cond is None:
        return x * a_main[:, None, :] + b_main[:, None, :]
    rows = (torch.arange(x.shape[1], device=x.device) < boundary)[None, :, None]
    a = torch.where(rows, a_main[:, None, :], a_cond[:, None, :])
    b = torch.where(rows, b_main[:, None, :], b_cond[:, None, :])
    return x * a + b


def _ln_mod(x, ln_mod):
    """layer_norm + per-segment adaLN affine (the reference's norm1/norm)."""
    a_m, b_m, a_c, b_c, boundary = ln_mod
    return _seg_affine(layer_norm(x), boundary, a_m, b_m, a_c, b_c)


def gate_res_linear(p: Params, x, resid, g_main, g_cond, boundary: int,
                    use_lora: bool = True, lora_mask=None, w8a8: bool = False,
                    fuse_gate: bool = False, tp_kind: str = "row"):
    """resid + gate_seg(row) * linear(x): the adaLN-zero gated residual,
    in the kernel's store epilogue under ``fuse_gate`` where fusable (under
    a tensor context after the row split's sum, `tp_quant_matmul_stacked`).
    ``tp_kind``: "row", or "row_cat" over the single blocks' [attention |
    MLP] concat."""
    if _elementwise_fusable(p, x, use_lora, fuse_gate):
        b, s, k = x.shape
        nb, _, n = p["kernel_q"].shape
        x2, wq, blk = x.reshape(s, k), p["kernel_q"], p["_blk"]
        sc, bias3 = p["kernel_scale"].reshape(nb, 1, n), _bias3(p, n)
        r2 = resid.reshape(s, n)
        gate = _rows8([g_main, g_main if g_cond is None else g_cond], n)
        _refuse_tp_training("fuse_gate")
        if current_tp() is not None:
            y = tp_quant_matmul_stacked(
                "row", x2, wq, sc, blk, bias2=p.get("bias"),
                seg_boundary=boundary, resid=r2, gate=gate, w8a8=w8a8)
        elif torch.is_grad_enabled():
            y = qmm.quant_gate_res_linear_stacked(
                x2, wq, sc, bias3, r2, gate, blk, seg_boundary=boundary,
                w8a8=w8a8)
        else:
            y = qmm.quant_matmul_stacked(
                x2, wq, sc, blk, bias3=bias3, w8a8=w8a8, resid=r2, gate=gate,
                seg_boundary=boundary)
        return y.reshape(b, s, n).to(resid.dtype)
    h = linear(p, x, use_lora, lora_mask, w8a8, tp_kind)
    zero = torch.zeros_like(g_main)
    return resid + _seg_affine(h, boundary, g_main, zero, g_cond, zero)


def _attn_mode(flags: Dict[str, Any]) -> str:
    if not flags.get("union_cond_attn", True):
        return "no_union"
    if flags.get("independent_condition", False):
        return "independent"
    return "union"


def _attention(q, k, v, s_cond: int, flags, c_factor, rope_full,
               int8_attn: bool = False):
    """Flash attention (bshd) on the heads this rank holds (under a tensor
    context its shard: heads are independent, nothing is exchanged)."""
    s = q.shape[1]
    out = fa.flash_attention(q, k, v, cond_start=s - s_cond,
                             mode=_attn_mode(flags) if s_cond else "union",
                             c_factor=c_factor if s_cond else None,
                             rope=rope_full, layout="bshd", int8_attn=int8_attn)
    b, _, h, d = out.shape
    return out.reshape(b, s, h * d)


def double_block_forward(block: Params, cfg: FluxConfig, img, txt, cond, temb,
                         cond_temb, rope_full, flags: Dict[str, Any],
                         c_factor: Optional[float], w8a8: bool = False,
                         int8_attn: bool = False, fuse_ln: bool = False,
                         fuse_gate: bool = False):
    """One dual-stream block; img and cond ride one fused latent stream with
    per-segment modulation, gating and LoRA masks."""
    use_cond = cond is not None
    latent_lora = bool(flags.get("latent_lora", False))
    nh = cfg.num_heads // tensor_extent()  # the heads this rank holds
    s_img, s_txt = img.shape[1], txt.shape[1]
    s_cond = cond.shape[1] if use_cond else 0

    lat = torch.cat([img, cond], dim=1) if use_cond else img
    luse, lmask = _seg_lora(s_img, s_cond, latent_lora, lat.dtype, lat.device)
    mi, mc = _mod_pair(block["norm1"], temb, cond_temb if use_cond else None,
                       latent_lora, 6, w8a8)
    mt = _mod6(block["norm1_context"], temb, w8a8)

    lm_attn = (1.0 + mi[1], mi[0], (1.0 + mc[1]) if use_cond else None,
               mc[0] if use_cond else None, s_img)
    n_txt = layer_norm(txt) * (1.0 + mt[1][:, None, :]) + mt[0][:, None, :]

    attn = block["attn"]
    q_l, k_l, v_l = _qkv(attn, lat, nh, "to", luse, lmask, w8a8, lm_attn,
                         fuse_ln)
    q_t, k_t, v_t = _qkv(attn, n_txt, nh, "add", False, None, w8a8)
    q = torch.cat([q_t, q_l], dim=1)
    k = torch.cat([k_t, k_l], dim=1)
    v = torch.cat([v_t, v_l], dim=1)
    out = _attention(q, k, v, s_cond, flags, c_factor, rope_full, int8_attn)

    attn_txt = linear(attn["to_add_out"], out[:, :s_txt], False, None, w8a8,
                      "row")
    if use_cond and flags.get("add_cond_attn", False):
        if s_cond != s_img:
            raise ValueError(
                "add_cond_attn requires equal image and condition token "
                f"counts (img {s_img}, cond {s_cond})")
        attn_lat = linear(attn["to_out"], out[:, s_txt:], luse, lmask, w8a8,
                          "row")
        zero = torch.zeros_like(mi[2])
        gated = _seg_affine(attn_lat, s_img, mi[2], zero, mc[2], zero)
        gated = torch.cat([gated[:, :s_img] + gated[:, s_img:],
                           gated[:, s_img:]], dim=1)
        lat = lat + gated
    else:
        lat = gate_res_linear(attn["to_out"], out[:, s_txt:], lat, mi[2],
                              mc[2] if use_cond else None, s_img, luse, lmask,
                              w8a8, fuse_gate)
    txt = txt + mt[2][:, None, :] * attn_txt

    ln_ff = (1.0 + mi[4], mi[3], (1.0 + mc[4]) if use_cond else None,
             mc[3] if use_cond else None, s_img)
    h = ln_mod_linear(block["ff"]["in"], lat, ln_ff, "gelu_tanh", False, None,
                      w8a8, fuse_ln)
    lat = gate_res_linear(block["ff"]["out"], h, lat, mi[5],
                          mc[5] if use_cond else None, s_img, luse, lmask, w8a8,
                          fuse_gate)

    n2t = layer_norm(txt) * (1.0 + mt[4][:, None, :]) + mt[3][:, None, :]
    ht = linear_gelu(block["ff_context"]["in"], n2t, False, None, w8a8, "col")
    ht = linear(block["ff_context"]["out"], ht, False, None, w8a8, "row")
    txt = txt + mt[5][:, None, :] * ht
    return txt, lat[:, :s_img], lat[:, s_img:] if use_cond else None


def single_block_forward(block: Params, cfg: FluxConfig, x, cond, temb,
                         cond_temb, rope_full, flags: Dict[str, Any],
                         c_factor: Optional[float], w8a8: bool = False,
                         int8_attn: bool = False, fuse_ln: bool = False,
                         fuse_gate: bool = False):
    """One single-stream block over [txt + img] (+ cond), stream-fused."""
    use_cond = cond is not None
    latent_lora = bool(flags.get("latent_lora", False))
    nh = cfg.num_heads // tensor_extent()  # the heads this rank holds
    s_x = x.shape[1]
    s_cond = cond.shape[1] if use_cond else 0

    full = torch.cat([x, cond], dim=1) if use_cond else x
    luse, lmask = _seg_lora(s_x, s_cond, latent_lora, full.dtype, full.device)
    mx, mc = _mod_pair(block["norm"], temb, cond_temb if use_cond else None,
                       latent_lora, 3, w8a8)
    lm = (1.0 + mx[1], mx[0], (1.0 + mc[1]) if use_cond else None,
          mc[0] if use_cond else None, s_x)
    if fuse_ln:
        # proj_mlp and the qkv each take the raw stream and its prologue
        mlp_h = ln_mod_linear(block["proj_mlp"], full, lm, "gelu_tanh", luse,
                              lmask, w8a8, fuse_ln)
        q, k, v = _qkv(block["attn"], full, nh, "to", luse, lmask, w8a8, lm,
                       fuse_ln)
    else:
        # one copy (one dx sum under a tensor axis) for proj_mlp and the qkv
        normed = copy_to_tensor(_ln_mod(full, lm))
        mlp_h = linear_gelu(block["proj_mlp"], normed, luse, lmask, w8a8, "col")
        q, k, v = _qkv(block["attn"], normed, nh, "to", luse, lmask, w8a8)
    out = _attention(q, k, v, s_cond, flags, c_factor, rope_full, int8_attn)

    g_cond = mc[2] if use_cond else None
    if "proj_out_mlp" in block:
        # split proj_out: y = x_attn W[:h] + x_mlp W[h:] + b, accumulated
        # through the gated residual (never builds the [S, h + mlp] concat)
        full = gate_res_linear(block["proj_out"], out, full, mx[2], g_cond,
                               s_x, luse, lmask, w8a8, fuse_gate)
        full = gate_res_linear(block["proj_out_mlp"], mlp_h, full, mx[2],
                               g_cond, s_x, luse, lmask, w8a8, fuse_gate)
    else:
        full = gate_res_linear(block["proj_out"], torch.cat([out, mlp_h], -1),
                               full, mx[2], g_cond, s_x, luse, lmask, w8a8,
                               fuse_gate, "row_cat")
    return full[:, :s_x], full[:, s_x:] if use_cond else None


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def _cn_residuals(samples: Optional[torch.Tensor], n_blocks: int, dtype):
    """Block index -> its ControlNet residual: block i takes sample
    i // ceil(n_blocks / N) of the [N, ...] stack (None: no residuals)."""
    if samples is None:
        return None
    samples = samples.to(dtype)
    every = -(-n_blocks // samples.shape[0])
    return lambda i: samples[i // every]


def _rerun_spanned(block_fn, *args):
    """A checkpointed block: its re-run in the backward (a graph task runs
    on this thread) is the span ``train.recompute``."""
    if torch._C._current_graph_task_id() == -1:
        return block_fn(*args)
    with span("train.recompute"):
        return block_fn(*args)


def flux_forward(params: Params, cfg: FluxConfig, *, img: torch.Tensor,
                 txt: torch.Tensor, pooled: torch.Tensor,
                 timestep: torch.Tensor, img_ids: torch.Tensor,
                 txt_ids: torch.Tensor, guidance: Optional[torch.Tensor] = None,
                 cond: Optional[torch.Tensor] = None,
                 cond_ids: Optional[torch.Tensor] = None,
                 flags: Optional[Dict[str, Any]] = None, c_t: float = 0.0,
                 c_factor: Optional[float] = None, w8a8: bool = False,
                 controlnet_block_samples: Optional[torch.Tensor] = None,
                 controlnet_single_block_samples: Optional[torch.Tensor] = None,
                 remat: bool = False, int8_attn: bool = False,
                 fuse_ln: bool = False, fuse_gate: bool = False) -> torch.Tensor:
    """Conditioned FLUX forward -> [B, S_img, in_channels] velocity.

    img/cond: [B, S, in_channels] packed latent tokens; txt [B, S_txt,
    joint_dim]; pooled [B, pooled_dim]; timestep / guidance [B] (scaled by
    1000 here); *_ids [S, 3]; c_factor: condition strength (None = 1);
    remat: checkpoint each block when grad is enabled (gradient
    checkpointing: its activations are recomputed in the backward);
    int8_attn: int8 QK^T scores in every attention (inference only);
    fuse_ln / fuse_gate: the LN + adaLN prologue / gate + residual epilogue
    in the int8 kernels where fusable (see the module docstring);
    controlnet_block_samples / controlnet_single_block_samples: [N, B,
    S_img, hidden] residuals added to the img stream after each double
    block / to the img part of [txt | img] after each single block, block
    i taking sample i // ceil(n_blocks / N) (cast to img's dtype)."""
    flags = flags or {}
    use_cond = cond is not None
    latent_lora = bool(flags.get("latent_lora", False))
    wdt = img.dtype
    txt, pooled = txt.to(wdt), pooled.to(wdt)
    if use_cond:
        cond = cond.to(wdt)
    cn_dbl = _cn_residuals(controlnet_block_samples, cfg.num_double_blocks, wdt)
    cn_sgl = _cn_residuals(controlnet_single_block_samples,
                           cfg.num_single_blocks, wdt)

    img_h = linear(params["x_embedder"], img, latent_lora, None, w8a8)
    cond_h = (linear(params["x_embedder"], cond, True, None, w8a8)
              if use_cond else None)
    txt_h = linear(params["context_embedder"], txt, False, None, w8a8)

    t1000 = timestep.float() * 1000.0
    g1000 = (guidance.float() * 1000.0
             if guidance is not None and cfg.guidance_embeds else None)
    temb = combined_timestep_embed(params, cfg, t1000, pooled, g1000, w8a8)
    cond_temb = None
    if use_cond:
        ct = torch.full_like(t1000, c_t * 1000.0)
        cond_temb = combined_timestep_embed(params, cfg, ct, pooled, g1000,
                                            w8a8)

    ids = [txt_ids, img_ids] + ([cond_ids] if use_cond else [])
    rope_full = rope_embed(torch.cat(ids, dim=0), cfg.axes_dims, cfg.theta)

    remat = remat and torch.is_grad_enabled()

    def run(block_fn, *args):
        if remat:
            return checkpoint(_rerun_spanned, block_fn, *args,
                              use_reentrant=False)
        return block_fn(*args)

    def double(i, img_h, txt_h, cond_h):
        txt_h, img_h, cond_h = double_block_forward(
            _block_view(params["double_blocks"], i), cfg, img_h, txt_h, cond_h,
            temb, cond_temb, rope_full, flags, c_factor, w8a8, int8_attn,
            fuse_ln, fuse_gate)
        if cn_dbl is not None:
            img_h = img_h + cn_dbl(i)
        return txt_h, img_h, cond_h

    def single(i, x, cond_h):
        x, cond_h = single_block_forward(
            _block_view(params["single_blocks"], i), cfg, x, cond_h, temb,
            cond_temb, rope_full, flags, c_factor, w8a8, int8_attn, fuse_ln,
            fuse_gate)
        if cn_sgl is not None:
            x = torch.cat([x[:, :s_txt], x[:, s_txt:] + cn_sgl(i)], dim=1)
        return x, cond_h

    for i in range(cfg.num_double_blocks):
        txt_h, img_h, cond_h = run(double, i, img_h, txt_h, cond_h)

    s_txt = txt_h.shape[1]
    x = torch.cat([txt_h, img_h], dim=1)
    for i in range(cfg.num_single_blocks):
        x, cond_h = run(single, i, x, cond_h)
    x = x[:, s_txt:]

    mod = linear(params["norm_out"]["linear"], silu(temb), False, None, w8a8)
    scale, shift = mod.chunk(2, dim=-1)
    x = layer_norm(x) * (1.0 + scale[:, None, :]) + shift[:, None, :]
    return linear(params["proj_out"], x, False, None, w8a8)
