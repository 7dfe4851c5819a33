"""T5 v1.1 encoder, FLUX's prompt encoder (counterpart of
``loongx_tpu/models/text/t5.py``).

T5 v1.1-XXL: d_model 4096, 24 layers, 64 heads, d_kv 64, d_ff 10240,
gated-GELU feed-forward, RMSNorm, a relative position bias shared from layer
0, no attention-score scaling.  Params keep the JAX package's tree: block
params stacked ``[NB, ...]``, linears ``[in, out]`` without bias.

An int8 tree (`ops.quant.quantize_tree`) on CUDA runs every block linear
through the stacked quant-matmul kernel (``quant_matmul_stacked``,
weight-only, the block index as a pointer offset, gelu_tanh fused on
``wi_0``): seven launches per layer, 168 per prompt at XXL.  The attention
itself (relative-position bias, no scaling) is plain PyTorch matmuls, as the
JAX package computes it with einsum outside any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from loongx_tpu_torch.ops import quant_matmul as qmm
from loongx_tpu_torch.ops.nn import (
    Params, gelu_tanh, init_linear, normal, qdot, rms_norm, stack_trees,
)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    rel_pos_buckets: int = 32
    rel_pos_max_distance: int = 128
    layer_norm_eps: float = 1e-6

    @staticmethod
    def xxl() -> "T5Config":
        return T5Config()

    @staticmethod
    def tiny() -> "T5Config":
        return T5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64,
                        num_layers=2, num_heads=4)


_BLOCK_LINEARS = ("q", "k", "v", "o", "wi_0", "wi_1", "wo")


def init_t5_params(cfg: T5Config, *, generator=None, dtype=torch.bfloat16,
                   device="cuda") -> Params:
    """Random params in the JAX package's layout (its init's distributions:
    nn.Linear-style uniform kernels, N(0, 1) embeddings, N(0, 0.02^2)
    relative-position bias)."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    inner = cfg.num_heads * cfg.d_kv

    def block():
        return {
            "ln_attn": {"weight": torch.ones(cfg.d_model, dtype=dtype,
                                             device=device)},
            "q": init_linear(cfg.d_model, inner, bias=False, **kw),
            "k": init_linear(cfg.d_model, inner, bias=False, **kw),
            "v": init_linear(cfg.d_model, inner, bias=False, **kw),
            "o": init_linear(inner, cfg.d_model, bias=False, **kw),
            "ln_ff": {"weight": torch.ones(cfg.d_model, dtype=dtype,
                                           device=device)},
            "wi_0": init_linear(cfg.d_model, cfg.d_ff, bias=False, **kw),
            "wi_1": init_linear(cfg.d_model, cfg.d_ff, bias=False, **kw),
            "wo": init_linear(cfg.d_ff, cfg.d_model, bias=False, **kw),
        }

    rel = normal((cfg.rel_pos_buckets, cfg.num_heads), generator=generator,
                 device=device)
    return {
        "embed": normal((cfg.vocab_size, cfg.d_model), **kw),
        "rel_pos_bias": (rel.to(dtype) * 0.02),
        "blocks": stack_trees([block() for _ in range(cfg.num_layers)]),
        "final_ln": {"weight": torch.ones(cfg.d_model, dtype=dtype,
                                          device=device)},
    }


def _relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """Bidirectional T5 relative-position bucketing, in the JAX package's
    float32 arithmetic (a one-ulp change of the log would move a bucket)."""
    num_buckets //= 2
    ret = torch.where(rel_pos > 0, num_buckets, 0)
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.tensor(np.float32(np.log(max_distance / max_exact)),
                             device=rel_pos.device)
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9) / log_ratio
        * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


def t5_rel_pos_bias(params: Params, cfg: T5Config,
                    seq_len: int) -> torch.Tensor:
    """[1, H, S, S] float32 additive attention bias."""
    device = params["rel_pos_bias"].device
    ctx = torch.arange(seq_len, device=device)[:, None]
    mem = torch.arange(seq_len, device=device)[None, :]
    buckets = _relative_position_bucket(mem - ctx, cfg.rel_pos_buckets,
                                        cfg.rel_pos_max_distance)
    bias = params["rel_pos_bias"][buckets.long()]  # [S, S, H]
    return bias.permute(2, 0, 1)[None].float()


def _t5_block(cfg: T5Config, bias, b: int, s: int, x, ln_attn_w, ln_ff_w, mm):
    """One T5 block (pre-norm self-attention, no score scaling, gated-GELU
    FF), shared by both paths; ``mm(name, t, activation)`` issues a linear."""
    h = rms_norm(x, ln_attn_w, cfg.layer_norm_eps)

    def heads(t):
        return t.to(x.dtype).reshape(b, s, cfg.num_heads,
                                     cfg.d_kv).transpose(1, 2)

    q, k, v = (heads(mm(nm, h)) for nm in ("q", "k", "v"))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    attn = torch.matmul(probs.float(), v.float()).to(x.dtype)
    attn = attn.transpose(1, 2).reshape(b, s, -1)
    x = x + mm("o", attn).to(x.dtype)

    h = rms_norm(x, ln_ff_w, cfg.layer_norm_eps)
    gelu = mm("wi_0", h, activation="gelu_tanh")
    lin = mm("wi_1", h)
    ff = mm("wo", (gelu * lin).to(x.dtype)).to(x.dtype)
    return x + ff


def t5_encode(params: Params, cfg: T5Config, input_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None,
              stacked_kernels: Optional[bool] = None) -> torch.Tensor:
    """input_ids [B, S] -> embeddings [B, S, d_model].

    ``stacked_kernels``: None = stacked iff every block linear is int8 and
    the params lie on a CUDA device; True forces the stacked path (its
    plain version on CPU) and raises unless every block linear is int8;
    False takes the dequantising path (`ops.nn.qdot`)."""
    b, s = input_ids.shape
    x = params["embed"][input_ids.to(params["embed"].device).long()]
    bias = t5_rel_pos_bias(params, cfg, s)
    if attention_mask is not None:
        mask = attention_mask.to(x.device)[:, None, None, :] > 0
        bias = bias + torch.where(mask, 0.0, -1e9)

    blocks = params["blocks"]
    n_quant = sum("kernel_q" in blocks[nm] for nm in _BLOCK_LINEARS)
    quantized = n_quant == len(_BLOCK_LINEARS)
    if stacked_kernels is None:
        stacked_kernels = quantized and x.device.type == "cuda"
    elif stacked_kernels and not quantized:
        raise ValueError(
            "stacked_kernels=True requires a fully int8-quantized T5 "
            f"(quantize_tree): {n_quant}/{len(_BLOCK_LINEARS)} block "
            "linears carry int8 weights")

    for i in range(cfg.num_layers):
        if stacked_kernels:
            def mm(name, t, activation=None, i=i):
                p = blocks[name]
                y = qmm.quant_matmul_stacked(
                    t.reshape(b * s, t.shape[-1]), p["kernel_q"],
                    p["kernel_scale"], i, activation=activation, w8a8=False)
                return y.reshape(b, s, -1)
        else:
            def mm(name, t, activation=None, i=i):
                p = blocks[name]
                leaf = {k: v[i] for k, v in p.items()}
                y = qdot(leaf, t)
                return gelu_tanh(y) if activation == "gelu_tanh" else y
        x = _t5_block(cfg, bias, b, s, x, blocks["ln_attn"]["weight"][i],
                      blocks["ln_ff"]["weight"][i], mm)
    return rms_norm(x, params["final_ln"]["weight"], cfg.layer_norm_eps)
