"""CLIP text encoder, the ViT-L/14 text tower that gives FLUX its pooled
prompt embedding (counterpart of ``loongx_tpu/models/text/clip.py``).

CLIP-L text: hidden 768, 12 layers, 12 heads, d_ff 3072, quick-GELU, a
causal mask; the pooled output is the final-LN hidden state at the first EOS
token (the last token when there is none).  Linears may be int8: they are
dequantised per call (`ops.nn.qdot`), as in the JAX package, where this
encoder runs once per prompt outside any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from loongx_tpu_torch.ops.nn import (
    Params, init_layer_norm, init_linear, layer_norm, normal, qdot,
    stack_trees,
)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden: int = 768
    num_layers: int = 12
    num_heads: int = 12
    d_ff: int = 3072
    max_positions: int = 77
    eos_token_id: int = 49407
    layer_norm_eps: float = 1e-5

    @staticmethod
    def large() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=128, hidden=32, num_layers=2,
                              num_heads=4, d_ff=64, max_positions=16,
                              eos_token_id=127)


def _init_block(cfg, *, generator=None, dtype=torch.float32,
                device="cuda") -> Params:
    """One pre-LN block (q/k/v/o, fc1/fc2, two layer norms) of width
    ``cfg.hidden``; the CLIP vision tower's blocks share the layout."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    h = cfg.hidden
    return {
        "ln1": init_layer_norm(h, dtype=dtype, device=device),
        "q": init_linear(h, h, **kw),
        "k": init_linear(h, h, **kw),
        "v": init_linear(h, h, **kw),
        "o": init_linear(h, h, **kw),
        "ln2": init_layer_norm(h, dtype=dtype, device=device),
        "fc1": init_linear(h, cfg.d_ff, **kw),
        "fc2": init_linear(cfg.d_ff, h, **kw),
    }


def init_clip_params(cfg: CLIPTextConfig, *, generator=None,
                     dtype=torch.bfloat16, device="cuda") -> Params:
    """Random params in the JAX package's layout and distributions."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    h = cfg.hidden
    tok = normal((cfg.vocab_size, h), generator=generator, device=device)
    pos = normal((cfg.max_positions, h), generator=generator, device=device)
    return {
        "token_embed": (tok * 0.02).to(dtype),
        "pos_embed": (pos * 0.01).to(dtype),
        "blocks": stack_trees([_init_block(cfg, **kw)
                               for _ in range(cfg.num_layers)]),
        "final_ln": init_layer_norm(h, dtype=dtype, device=device),
    }


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _affine(p: Params, t: torch.Tensor) -> torch.Tensor:
    """(qdot + bias) in float32, cast to t's dtype."""
    return (qdot(p, t) + p["bias"].float()).to(t.dtype)


def clip_encode(params: Params, cfg: CLIPTextConfig, input_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """input_ids [B, S] -> (last_hidden [B, S, H], pooled [B, H])."""
    device = params["token_embed"].device
    input_ids = input_ids.to(device).long()
    b, s = input_ids.shape
    x = params["token_embed"][input_ids] + params["pos_embed"][:s]
    nh = cfg.num_heads
    scale = 1.0 / torch.sqrt(torch.tensor(float(cfg.hidden // nh)))
    causal = torch.where(
        torch.tril(torch.ones(s, s, dtype=torch.bool, device=device)),
        0.0, -torch.inf)[None, None]

    def heads(t):
        return t.reshape(b, s, nh, -1).transpose(1, 2)

    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        blk = {name: {k: v[i] for k, v in leaf.items()}
               for name, leaf in blocks.items()}
        h = layer_norm(x, blk["ln1"]["weight"], blk["ln1"]["bias"],
                       cfg.layer_norm_eps)
        q, k, v = (heads(_affine(blk[nm], h)) for nm in ("q", "k", "v"))
        logits = (torch.matmul(q.float(), k.float().transpose(-1, -2))
                  * scale.to(device) + causal)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.matmul(probs.float(), v.float()).to(x.dtype)
        attn = attn.transpose(1, 2).reshape(b, s, -1)
        x = x + _affine(blk["o"], attn)
        h = layer_norm(x, blk["ln2"]["weight"], blk["ln2"]["bias"],
                       cfg.layer_norm_eps)
        h = quick_gelu(_affine(blk["fc1"], h))
        x = x + _affine(blk["fc2"], h)
    x = layer_norm(x, params["final_ln"]["weight"], params["final_ln"]["bias"],
                   cfg.layer_norm_eps)
    # first EOS position per sequence, or the last token if there is none
    is_eos = input_ids == cfg.eos_token_id
    eos_pos = torch.where(is_eos.any(1), is_eos.int().argmax(1),
                          torch.full((b,), s - 1, device=device))
    pooled = x[torch.arange(b, device=device), eos_pos]
    return x, pooled


def clip_text_features(params: Params, cfg: CLIPTextConfig,
                       input_ids: torch.Tensor) -> torch.Tensor:
    """The pooled output through the text projection head (HF
    ``get_text_features``; the FLUX conditioning uses the raw pooled
    output)."""
    _, pooled = clip_encode(params, cfg, input_ids)
    if "text_projection" not in params:
        raise KeyError("params lack a text_projection head")
    return qdot(params["text_projection"], pooled)
