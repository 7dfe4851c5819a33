"""Flash attention for the unified [txt | img | cond] sequence (forward).

Counterpart of ``loongx_tpu/ops/flash_attention.py::flash_attention`` (the
TPU kernel ``_fwd_kernel``).  On a CUDA tensor this launches the hand-written
kernel in ``csrc/flash_attention.cu``; on a CPU tensor it runs the plain
version, `flash_attention_plain` (``ops/attention.unified_attention``'s
math).  There is no fallback between the two.

The mask structure comes from one boundary, ``cond_start`` (== S when there
is no condition stream); ``c_factor`` switches to the additive log-bias on
the cond <-> non-cond blocks and overrides ``mode``; ``rope`` = (cos, sin)
[S, D] float32 tables rotates q and k inside the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from loongx_tpu_torch.ops import cuda_build
from loongx_tpu_torch.ops.attention import MODES, unified_attention

_MODE_IDS = {"union": 0, "no_union": 1, "independent": 2, "cfactor": 3}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURE = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _I, _F,
              _F, _P]


def _dims(q: torch.Tensor, layout: str):
    if layout == "bhsd":
        b, h, s, d = q.shape
        return b, h, s, d, (h * s * d, d, s * d)
    if layout == "bshd":
        b, s, h, d = q.shape
        return b, h, s, d, (s * h * d, h * d, d)
    raise ValueError(f"unknown layout {layout!r}")


def flash_attention_plain(q, k, v, *, cond_start: int, mode: str = "union",
                          c_factor: Optional[float] = None,
                          rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          layout: str = "bhsd") -> torch.Tensor:
    """The kernel's contract in plain PyTorch (unified_attention)."""
    s = _dims(q, layout)[2]
    return unified_attention(q, k, v, cond_len=s - cond_start, mode=mode,
                             c_factor=c_factor, rope=rope, layout=layout)


def flash_attention(q, k, v, *, cond_start: int, mode: str = "union",
                    c_factor: Optional[float] = None,
                    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    layout: str = "bhsd") -> torch.Tensor:
    """Attention with condition block semantics; q/k/v [B, H, S, D] ("bhsd")
    or [B, S, H, D] ("bshd"), output in the same layout and dtype."""
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}")
    b, h, s, d, (sb, ss, sh) = _dims(q, layout)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, cond_start=cond_start, mode=mode,
                                     c_factor=c_factor, rope=rope,
                                     layout=layout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be bf16 {tuple(q.shape)} "
                             f"on {q.device}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and "
                             "16-byte aligned")
    if d not in (64, 128):
        raise ValueError(f"flash_attention: head_dim {d} not in (64, 128)")
    cos = sin = None
    if rope is not None:
        cos, sin = rope
        for t in (cos, sin):
            if (t.dtype != torch.float32 or tuple(t.shape) != (s, d)
                    or not t.is_contiguous() or t.device != q.device
                    or t.data_ptr() % 16):
                raise ValueError("flash_attention: rope tables must be "
                                 f"contiguous 16-byte aligned float32 [{s}, {d}] "
                                 f"on {q.device}")
    cbias = 0.0
    if c_factor is not None:
        mode = "cfactor"
        cbias = float(np.log(np.float32(c_factor)))
    out = torch.empty_like(q)
    lib = cuda_build.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              None if cos is None else cos.data_ptr(),
              None if sin is None else sin.data_ptr(),
              b, h, s, d, sb, ss, sh, cond_start, _MODE_IDS[mode], cbias,
              1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(code, "flash_attention_fwd")
    cuda_build.LAUNCHES["flash_attention"] += 1
    return out
