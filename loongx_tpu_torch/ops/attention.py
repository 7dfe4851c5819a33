"""Unified 3-stream attention for condition-token FLUX, in plain PyTorch.

Counterpart of ``loongx_tpu/ops/attention.py`` (the XLA path) and the plain
version the flash kernel (``ops/flash_attention.py``) is held against.  One
attention over [txt | img | cond]; the block structure depends only on the
boundary ``cond_start = S - cond_len``:

  * ``union``: full bidirectional attention;
  * ``no_union``: cond <-> non-cond blocked both ways;
  * ``independent``: cond queries blind to non-cond keys;
  * ``c_factor``: additive log-bias on both cross blocks, replacing any mask.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from loongx_tpu_torch.ops.rope import apply_rope

MODES = ("union", "no_union", "independent")


def _block_bias(s: int, cond_start: int, mode: str,
                c_factor: Optional[float], device) -> Optional[torch.Tensor]:
    """[S, S] float32 additive bias, or None for plain attention."""
    if c_factor is None and mode == "union":
        return None
    ids = torch.arange(s, device=device)
    row = (ids >= cond_start)[:, None]
    col = (ids >= cond_start)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    if c_factor is not None:
        logc = torch.log(torch.as_tensor(c_factor, dtype=torch.float32,
                                         device=device))
        return torch.where(row != col, logc, zero)
    if mode == "no_union":
        allowed = row == col
    elif mode == "independent":
        allowed = ~(row & ~col)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    return torch.where(allowed, zero, torch.full((), -math.inf,
                                                  device=device))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention on [B, H, S, D]: float32 logits and softmax, the
    probabilities cast to v's dtype before PV, float32 accumulation."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def unified_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      cond_len: int = 0, mode: str = "union",
                      c_factor: Optional[float] = None,
                      rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      layout: str = "bhsd") -> torch.Tensor:
    """Attention over the unified sequence; the last ``cond_len`` positions
    are condition tokens.  q/k/v are [B, H, S, D] ("bhsd") or [B, S, H, D]
    ("bshd"); ``rope`` = (cos, sin) [S, D] rotates q and k first.  Returns
    the input layout in q's dtype."""
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}")
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"unknown layout {layout!r}")
    bshd = layout == "bshd"
    s = q.shape[1] if bshd else q.shape[2]
    cond_start = s - cond_len
    if cond_len == 0:
        mode, c_factor = "union", None
    if bshd:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    bias = _block_bias(s, cond_start, mode, c_factor, q.device)
    out = attention_plain(q, k, v, bias)
    return out.transpose(1, 2) if bshd else out
