"""Unified 3-stream attention for condition-token FLUX, in plain PyTorch.

Counterpart of ``loongx_tpu/ops/attention.py`` (the XLA path) and the plain
version the flash kernel (``ops/flash_attention.py``) is held against.  One
attention over [txt | img | cond]; the block structure depends only on the
boundary ``cond_start = S - cond_len``:

  * ``union``: full bidirectional attention;
  * ``no_union``: cond <-> non-cond blocked both ways;
  * ``independent``: cond queries blind to non-cond keys;
  * ``c_factor``: additive log-bias on both cross blocks, replacing any mask.

``int8_attn`` computes the scores as the TPU kernel's int8 QK^T mode does
(``loongx_tpu/ops/flash_attention.py:228-291``, served when the JAX package
reads LOONGX_INT8_ATTN=1): q and k, after RoPE and its rounding to their
dtype, are quantized -- sc = absmax / 127 (1 when absmax is 0), codes =
clip(round(x / sc), -127, 127) -- q per row, k with one scale per span of
the TPU kernel's key tile ``block_k`` (`auto_blocks`; the whole padded row
at every FLUX length), and the scores are (q_codes . k_codes) * (q_scale *
k_scale).  The softmax and the probabilities' product with v are unchanged.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from loongx_tpu_torch.ops.rope import apply_rope

MODES = ("union", "no_union", "independent")

# The TPU forward kernel's block policy (``flash_attention.py:67-137``),
# copied: in the int8 mode its key tile is the span of one k scale.
LANES = 128
MAX_BLOCK_Q = 1280
MAX_BLOCK_K = 2560
FULLROW_SCORES_BYTES = 24 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def auto_blocks(seq_len: int) -> Tuple[int, int]:
    """(block_q, block_k) of the TPU kernel at sequence length ``seq_len``:
    one (S, S) tile up to 2560 padded rows, full-row key tiles above while
    a [512, S] float32 score tile fits 24 MB, then square 1280 x 2560 tiles
    for multiples of 2560, else 4352-wide online-softmax tiles."""
    s128 = _round_up(seq_len, LANES)
    if s128 <= MAX_BLOCK_K:
        return s128, s128
    if 512 * s128 * 4 <= FULLROW_SCORES_BYTES:
        for bq in (512, 384, 256):
            if s128 % bq == 0:
                return bq, s128
    if s128 % MAX_BLOCK_K == 0:
        return MAX_BLOCK_Q, MAX_BLOCK_K
    long_bk = 4352
    ntiles = -(-s128 // long_bk)
    bk = _round_up(-(-s128 // ntiles), LANES)
    s_pad = _round_up(s128, bk)
    for bq in (512, 384, 256, LANES):
        if s_pad % bq == 0:
            return bq, bk
    raise AssertionError(f"unreachable: s_pad={s_pad} is a multiple of {LANES}")


def int8_key_span(seq_len: int, block_k: Optional[int] = None) -> int:
    """Keys per k scale in the int8 mode: the TPU kernel's block_k, from
    `auto_blocks` or an explicit ``block_k`` clamped as the JAX wrapper
    clamps it."""
    if block_k is None:
        return auto_blocks(seq_len)[1]
    return min(block_k, _round_up(seq_len, LANES))


def _int8_scale(absmax: torch.Tensor) -> torch.Tensor:
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the true quotient in the last bit
    return torch.where(absmax == 0, torch.ones_like(absmax),
                       absmax / absmax.new_full((), 127.0))


def _int8_codes(x: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / sc), -127, 127)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., S, D] -> (integer-valued float32 codes, float32 scale
    [..., S, 1]), one scale per row."""
    xf = x.float()
    sc = _int8_scale(xf.abs().amax(-1, keepdim=True))
    return _int8_codes(xf, sc), sc


def quantize_spans(x: torch.Tensor, span: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., S, D] -> (integer-valued float32 codes, float32 scale
    [..., ceil(S / span)]), one scale per span of ``span`` rows (rows past S
    count as zeros, as the TPU kernel's padded keys do)."""
    xf = x.float()
    s = xf.shape[-2]
    nspan = -(-s // span)
    padded = torch.nn.functional.pad(xf, (0, 0, 0, nspan * span - s))
    absmax = padded.unflatten(-2, (nspan, span)).abs().amax((-2, -1))
    sc = _int8_scale(absmax)
    rows = sc.repeat_interleave(span, dim=-1)[..., :s, None]
    return _int8_codes(xf, rows), sc


def int8_scores(q: torch.Tensor, k: torch.Tensor, span: int) -> torch.Tensor:
    """float32 [..., S, S] scores (q_codes . k_codes) * (q_scale * k_scale)
    of q / k [..., S, D].  The integer product is exact in float32: every
    partial sum is an integer of magnitude <= 127^2 * D < 2^24."""
    qc, qs = quantize_rows(q)
    kc, ks = quantize_spans(k, span)
    ks_row = ks.repeat_interleave(span, dim=-1)[..., None, :k.shape[-2]]
    return torch.matmul(qc, kc.transpose(-1, -2)) * (qs * ks_row)


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
                    bias: Optional[torch.Tensor] = None,
                    int8_span: Optional[int] = None) -> torch.Tensor:
    """Softmax attention on [B, H, S, D]: float32 logits and softmax, the
    probabilities cast to v's dtype before PV, float32 accumulation.  With
    ``int8_span`` the scores are `int8_scores` with that k-scale span."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if int8_span is None:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    else:
        scores = int8_scores(q, k, int8_span)
    logits = scores * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# The JAX package's name for its reference attention (``attention_xla``):
# the same function, kept under one body.
attention_xla = attention_plain


def unified_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      cond_len: int = 0, mode: str = "union",
                      c_factor: Optional[float] = None,
                      rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      layout: str = "bhsd", int8_attn: bool = False,
                      block_k: Optional[int] = None) -> torch.Tensor:
    """Attention over the unified sequence; the last ``cond_len`` positions
    are condition tokens.  q/k/v are [B, H, S, D] ("bhsd") or [B, S, H, D]
    ("bshd"); ``rope`` = (cos, sin) [S, D] rotates q and k first.
    ``int8_attn`` takes int8 scores with the k-scale span
    `int8_key_span`(S, ``block_k``).  Returns the input layout in q's
    dtype."""
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
    span = int8_key_span(s, block_k) if int8_attn else None
    out = attention_plain(q, k, v, bias, span)
    return out.transpose(1, 2) if bshd else out
