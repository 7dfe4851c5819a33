"""Flash attention for the unified [txt | img | cond] sequence, forward and
backward.

Counterpart of ``loongx_tpu/ops/flash_attention.py::flash_attention`` (the
TPU kernels ``_fwd_kernel``, ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``).
On CUDA tensors this launches the hand-written kernels in
``csrc/flash_attention.cu``; on CPU tensors it runs their plain versions
(`flash_attention_plain`, `flash_residuals_plain`,
`flash_attention_bwd_plain`).  There is no fallback between the two.

The mask structure comes from one boundary, ``cond_start`` (== S when there
is no condition stream); ``c_factor`` switches to the additive log-bias on
the cond <-> non-cond blocks and overrides ``mode``; ``rope`` = (cos, sin)
[S, D] float32 tables rotates q and k inside the kernel.

Two hand-written kernels take the bf16-score forward, picked by
`flash_fwd_route`: at head_dim 128 (every FLUX shape) the wgmma kernel
(``flash_fwd_wgmma_kernel``: TMA ring, two consumer warpgroups), after a
pre-pass (`flash_rope`) that rotates q and k once into a head-major buffer;
at head_dim 64 the ``mma.sync`` kernel, which rotates q and k as its tiles
load.  Each launch counts as ``flash_attention`` and as
``flash_attention:<route>``; the pre-pass as ``flash_rope``.

``int8_attn`` (serving only) selects the int8 QK^T mode of the TPU kernel
(``_fwd_kernel`` :228-291, the JAX package's LOONGX_INT8_ATTN=1): a
k-quantization pass (`flash_kquant`, two kernels of the same source)
rotates k, rounds it to bf16 and writes int8 codes with one scale per span
of the TPU kernel's key tile (`ops.attention.int8_key_span`); the scores
come from an s8 x s8 -> s32 product, (q_codes . k_codes) * (q_scale *
k_scale).  Two forward kernels, picked by `flash_int8_route`: at head_dim
128 with a span that is a multiple of 128 (every FLUX length) the wgmma
kernel in its int8 mode (s8 wgmma for the scores), after the pass has
also quantized q per row (`flash_int8_prepass`); otherwise the
``mma.sync`` kernel, which quantizes each q row on load.  Each launch
counts as ``flash_attention_int8`` and ``flash_attention_int8:<route>``,
the pass as ``flash_kquant``.  The softmax and the bf16 P.V are the
bf16-score kernel's.  Under autograd the mode is off, as in JAX: the
backward rebuilds P from bf16 scores.

Under autograd (any of q/k/v requires grad) `flash_attention` runs the
forward with ``save_residuals`` and its backward launches the dK/dV and dQ
kernels, with ``di = rowsum(o * do)`` taken in float32 outside them, as the
JAX package does.  Two hand-written pairs take the backward, picked by
`flash_bwd_route`: at head_dim 128 the wgmma kernels
(``flash_bwd_dkv_wgmma_kernel``, ``flash_bwd_dq_wgmma_kernel``), which read
q and k already rotated: the autograd Function saves the forward's RoPE
pre-pass output in their place, so the backward runs no second pre-pass;
at head_dim 64 the ``mma.sync`` pair, which rotates q and k as its tiles
load.  Each launch counts as ``flash_bwd_dkv`` / ``flash_bwd_dq`` and as
``<name>:<route>``.  The residuals are base 2 (the kernels' softmax base):

    s2_ij = fl(q_i . k_j) * fl(scale * log2 e)   (masked: MASK_VALUE)
    m2_i  = max_j s2_ij,   l_i = sum_j 2^(s2_ij - m2_i)
    P_ij  = 2^(s2_ij - m2_i) / l_i

so the JAX package's natural-base m is ``m2 / log2 e`` and its l is ``l``.
Both are float32 [B, H, S] in either layout.  The ``c_factor`` mode's
backward is a plain float32 recompute on every device (the JAX package has
no kernel for it either).  The RoPE tables get no gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from loongx_tpu_torch.ops import cuda_build
from loongx_tpu_torch.ops.attention import (
    MODES, _block_bias, int8_key_span, quantize_rows, quantize_spans,
    unified_attention,
)
from loongx_tpu_torch.ops.rope import apply_rope

_MODE_IDS = {"union": 0, "no_union": 1, "independent": 2, "cfactor": 3}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FWD_SIGNATURE = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L,
                  _I, _I, _F, _F, _P]
_DKV_SIGNATURE = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                  _L, _L, _L, _I, _I, _F, _P]
_DQ_SIGNATURE = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L,
                 _L, _L, _I, _I, _F, _P]
_DKV_WGMMA_SIGNATURE = [_P] * 11 + [_I] * 4 + [_L] * 6 + [_I, _I, _F, _P]
_DQ_WGMMA_SIGNATURE = [_P] * 10 + [_I] * 4 + [_L] * 6 + [_I, _I, _F, _P]
_KQUANT_SIGNATURE = [_P] * 9 + [_I] * 4 + [_L] * 3 + [_I, _I, _P]
_WGMMA_SIGNATURE = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L,
                    _L, _I, _I, _F, _F, _P]
_ROPE_SIGNATURE = [_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _P]
_FWD_INT8_SIGNATURE = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L,
                       _I, _I, _F, _F, _I, _I, _P]
_FWD_INT8_WGMMA_SIGNATURE = ([_P] * 6 + [_I] * 4 + [_L] * 3
                             + [_I, _I, _F, _F, _I, _I, _P])
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
LOG2E = 1.4426950408889634

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _dims(q: torch.Tensor, layout: str):
    if layout == "bhsd":
        b, h, s, d = q.shape
        return b, h, s, d, (h * s * d, d, s * d)
    if layout == "bshd":
        b, s, h, d = q.shape
        return b, h, s, d, (s * h * d, h * d, d)
    raise ValueError(f"unknown layout {layout!r}")


def flash_fwd_route(d: int) -> str:
    """The bf16-score forward kernel for head_dim ``d``: ``"wgmma"`` at 128
    (its tiles are 64-wide d panels, two per row), ``"mma_sync"``
    otherwise."""
    return "wgmma" if d == 128 else "mma_sync"


def flash_bwd_route(d: int) -> str:
    """The backward kernels for head_dim ``d``: the forward's route, since
    the wgmma backward reads the wgmma forward's rotated q and k."""
    return flash_fwd_route(d)


def flash_int8_route(d: int, span: int) -> str:
    """The int8 QK^T forward for head_dim ``d`` and k-scale span ``span``:
    ``"wgmma"`` at 128 where a 128-key tile lies in one span (``span`` a
    multiple of 128: every FLUX length), ``"mma_sync"`` otherwise."""
    return "wgmma" if d == 128 and span % 128 == 0 else "mma_sync"


def active_int8_route(d: int, span: int) -> str:
    """The route an int8 QK^T launch takes now: the forced route of
    `cuda_build.mma_sync_only` if any, else `flash_int8_route`."""
    return cuda_build.FORCED_ROUTE or flash_int8_route(d, span)


def active_route(d: int) -> str:
    """The route a launch at head_dim ``d`` takes now, forward or backward:
    the forced route of `cuda_build.mma_sync_only` if any, else the rule."""
    return cuda_build.FORCED_ROUTE or flash_bwd_route(d)


def _scales(d: int) -> Tuple[float, float]:
    """(scale, scale * log2 e) as the kernels compute them in float32."""
    scale = np.float32(1.0 / math.sqrt(d))
    return float(scale), float(scale * np.float32(LOG2E))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def flash_attention_plain(q, k, v, *, cond_start: int, mode: str = "union",
                          c_factor: Optional[float] = None, rope: Rope = None,
                          layout: str = "bhsd", int8_attn: bool = False,
                          block_k: Optional[int] = None) -> torch.Tensor:
    """The forward kernel's contract in plain PyTorch (unified_attention),
    in either score mode."""
    s = _dims(q, layout)[2]
    return unified_attention(q, k, v, cond_len=s - cond_start, mode=mode,
                             c_factor=c_factor, rope=rope, layout=layout,
                             int8_attn=int8_attn, block_k=block_k)


def flash_kquant_plain(k, *, span: int, rope: Rope = None,
                       layout: str = "bhsd"):
    """The k-quantization pass in plain PyTorch: k rotated and rounded to
    its dtype -> (int8 codes [B, H, S, D], float32 scales [B, H,
    ceil(S / span)])."""
    (k,) = _head_major(layout, k)
    if rope is not None:
        k = apply_rope(k, *rope)
    codes, scales = quantize_spans(k, span)
    return codes.to(torch.int8).contiguous(), scales


def flash_int8_prepass_plain(q, k, *, span: int, rope: Rope = None,
                             layout: str = "bhsd"):
    """The int8 wgmma route's pre-pass in plain PyTorch: q and k rotated and
    rounded to their dtype -> (q codes int8 [B, H, S, D], q scales float32
    [B, H, S], k codes int8 [B, H, S, D], k scales float32 [B, H, ceil(S /
    span)])."""
    (q,) = _head_major(layout, q)
    if rope is not None:
        q = apply_rope(q, *rope)
    qc, qs = quantize_rows(q)
    kc, ks = flash_kquant_plain(k, span=span, rope=rope, layout=layout)
    return qc.to(torch.int8).contiguous(), qs[..., 0].contiguous(), kc, ks


def flash_rope_plain(q, k, rope: Rope, layout: str = "bhsd") -> torch.Tensor:
    """The RoPE pre-pass in plain PyTorch: q and k rotated (float32, cast
    back) -> [2, B, H, S, D] in their dtype, head-major."""
    q, k = _head_major(layout, q, k)
    return torch.stack([apply_rope(q, *rope), apply_rope(k, *rope)])


def flash_rope(q, k, rope: Rope, layout: str = "bhsd") -> torch.Tensor:
    """The wgmma forward's RoPE pre-pass -> rotated [2, B, H, S, D]: the
    CUDA kernel on CUDA tensors (bf16, head_dim 128), `flash_rope_plain`
    on CPU tensors."""
    if q.device.type == "cpu":
        return flash_rope_plain(q, k, rope, layout)
    b, h, s, d, (sb, ss, sh) = _dims(q, layout)
    _check_cuda_qkv(q, (("q", q), ("k", k)), d)
    if d != 128:
        raise ValueError(f"flash_rope: head_dim {d} is not 128")
    cos_p, sin_p = _cuda_rope(rope, s, d, q.device)
    out = torch.empty(2, b, h, s, d, dtype=q.dtype, device=q.device)
    fn = cuda_build.library("flash_attention").flash_rope_prepass
    fn.argtypes, fn.restype = _ROPE_SIGNATURE, ctypes.c_int
    cuda_build.check(fn(q.data_ptr(), k.data_ptr(), cos_p, sin_p,
                        out.data_ptr(), b, h, s, sb, ss, sh,
                        torch.cuda.current_stream(q.device).cuda_stream),
                     "flash_rope_prepass")
    cuda_build.LAUNCHES["flash_rope"] += 1
    return out


def _head_major(layout: str, *ts):
    return [t.transpose(1, 2) if layout == "bshd" else t for t in ts]


def _scores2(q, k, cond_start: int, mode: str, rope: Rope):
    """(rotated q, rotated k, masked base-2 scores s2 float32 [B, H, S, S]);
    q/k head-major, rotated and rounded to their dtype as the kernels load
    them."""
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    s = q.shape[2]
    s2 = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s2 = s2 * _scales(q.shape[-1])[1]
    bias = _block_bias(s, cond_start, mode, None, q.device) if cond_start < s else None
    if bias is not None:
        s2 = torch.where(bias == 0, s2, torch.full_like(s2, MASK_VALUE))
    return q, k, s2


def flash_residuals_plain(q, k, *, cond_start: int, mode: str = "union",
                          rope: Rope = None, layout: str = "bhsd"):
    """The forward kernel's residuals (m2, l), float32 [B, H, S]."""
    q, k = _head_major(layout, q, k)
    _, _, s2 = _scores2(q, k, cond_start, mode, rope)
    m2 = s2.amax(-1)
    return m2, torch.exp2(s2 - m2[..., None]).sum(-1)


def _rope_back(g: torch.Tensor, cos, sin) -> torch.Tensor:
    """Transpose of the interleaved-pair rotation: g * cos - (g @ R) * sin
    with (g @ R)[2i] = -g[2i+1], (g @ R)[2i+1] = g[2i], in float32."""
    pair = g.unflatten(-1, (-1, 2))
    rot = torch.stack([-pair[..., 1], pair[..., 0]], dim=-1).flatten(-2)
    return g * cos - rot * sin


def flash_attention_bwd_plain(q, k, v, do, m2, l, di, *, cond_start: int,
                              mode: str = "union", rope: Rope = None,
                              layout: str = "bhsd", qk_rot=None):
    """The backward kernels' contract in plain PyTorch -> (dq, dk, dv) in
    v's layout and dtype.  P is rebuilt from the residuals (l == 0 rows take
    m2 = 0, l = 1); P and dS are rounded to the input dtype before their
    products, as they enter the tensor cores; sums are float32.  With
    ``qk_rot`` (the wgmma route's contract: `flash_rope`'s [2, B, H, S, D]
    output, or q and k head-major without RoPE) q and k are not read and
    only dq and dk are rotated back."""
    dt = v.dtype
    v, do = _head_major(layout, v, do)
    if qk_rot is None:
        q, k = _head_major(layout, q, k)
        qr, kr, s2 = _scores2(q, k, cond_start, mode, rope)
    else:
        qr, kr, s2 = _scores2(qk_rot[0], qk_rot[1], cond_start, mode, None)
    empty = l == 0
    m_safe = torch.where(empty, torch.zeros_like(m2), m2)
    inv_l = 1.0 / torch.where(empty, torch.ones_like(l), l)
    p = torch.exp2(s2 - m_safe[..., None]) * inv_l[..., None]
    dof, vf = do.float(), v.float()
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - di[..., None]) * _scales(v.shape[-1])[0]).to(dt).float()
    dq = torch.matmul(ds, kr.float())
    dk = torch.matmul(ds.transpose(-1, -2), qr.float())
    if rope is not None:
        dq, dk = _rope_back(dq, *rope), _rope_back(dk, *rope)
    return tuple(_head_major(layout, dq.to(dt), dk.to(dt), dv.to(dt)))


def _cfactor_bwd_plain(q, k, v, do, cond_start: int, c_factor: float,
                       rope: Rope, layout: str):
    """The c_factor mode's backward: exact float32 recompute (the JAX
    package's XLA path, ``_flash_attention_bwd`` :980-1009)."""
    dt = q.dtype
    q, k, v, do = (t.float() for t in _head_major(layout, q, k, v, do))
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    logits = logits + _block_bias(q.shape[2], cond_start, "union", c_factor,
                                  q.device)
    p = torch.softmax(logits, -1)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    if rope is not None:
        dq, dk = _rope_back(dq, *rope), _rope_back(dk, *rope)
    return tuple(_head_major(layout, dq.to(dt), dk.to(dt), dv.to(dt)))


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check_cuda_qkv(q, names_tensors, d: int) -> None:
    for name, t in names_tensors:
        if t.dtype != torch.bfloat16 or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be bf16 {tuple(q.shape)} "
                             f"on {q.device}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and "
                             "16-byte aligned")
    if d not in (64, 128):
        raise ValueError(f"flash_attention: head_dim {d} not in (64, 128)")


def _cuda_rope(rope: Rope, s: int, d: int, device):
    if rope is None:
        return None, None
    cos, sin = rope
    for t in (cos, sin):
        if (t.dtype != torch.float32 or tuple(t.shape) != (s, d)
                or not t.is_contiguous() or t.device != device
                or t.data_ptr() % 16):
            raise ValueError("flash_attention: rope tables must be "
                             f"contiguous 16-byte aligned float32 [{s}, {d}] "
                             f"on {device}")
    return cos.data_ptr(), sin.data_ptr()


def _stats_check(b: int, h: int, s: int, device, **stats) -> None:
    for name, t in stats.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, s)
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"flash_attention backward: {name} must be "
                             f"contiguous float32 [{b}, {h}, {s}] on {device}")


def flash_kquant(k, *, span: int, rope: Rope = None, layout: str = "bhsd"):
    """The int8 mode's k-quantization pass -> (int8 codes [B, H, S, D],
    float32 scales [B, H, ceil(S / span)]): the CUDA kernels on a CUDA
    tensor (bf16, ``span`` a multiple of 64), `flash_kquant_plain` on a CPU
    tensor."""
    if k.device.type == "cpu":
        return flash_kquant_plain(k, span=span, rope=rope, layout=layout)
    return _kquant(None, k, span, rope, layout)[2:]


def flash_int8_prepass(q, k, *, span: int, rope: Rope = None,
                       layout: str = "bhsd"):
    """The int8 wgmma route's pre-pass, the k pass that also quantizes q per
    row -> (q codes int8 [B, H, S, D], q scales float32 [B, H, S], k codes,
    k scales as `flash_kquant`'s): the CUDA kernels on CUDA tensors,
    `flash_int8_prepass_plain` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_int8_prepass_plain(q, k, span=span, rope=rope,
                                        layout=layout)
    return _kquant(q, k, span, rope, layout)


def _kquant(q, k, span: int, rope: Rope, layout: str):
    """One launch of the pre-pass's two kernels on CUDA tensors -> (q codes,
    q scales, k codes, k scales); the q parts are None without q.  Counts
    as ``flash_kquant``."""
    b, h, s, d, (sb, ss, sh) = _dims(k, layout)
    if k.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {k.device}")
    _check_cuda_qkv(k, (("k", k),) + ((("q", q),) if q is not None else ()), d)
    if span <= 0 or span % 64:
        raise ValueError(f"flash_kquant: span {span} is not a positive "
                         "multiple of 64")
    cos_p, sin_p = _cuda_rope(rope, s, d, k.device)
    nspan = -(-s // span)
    codes = torch.empty(b, h, s, d, dtype=torch.int8, device=k.device)
    scales = torch.empty(b, h, nspan, dtype=torch.float32, device=k.device)
    kmax = torch.empty(b, h, -(-s // 64), dtype=torch.float32, device=k.device)
    qc = qs = None
    if q is not None:
        qc = torch.empty_like(codes)
        qs = torch.empty(b, h, s, dtype=torch.float32, device=k.device)
    fn = cuda_build.entry("flash_attention", "flash_attention_kquant",
                          _KQUANT_SIGNATURE)
    cuda_build.check(fn(k.data_ptr(), _ptr(q), cos_p, sin_p, kmax.data_ptr(),
                        codes.data_ptr(), scales.data_ptr(), _ptr(qc), _ptr(qs),
                        b, h, s, d, sb, ss, sh, span, nspan,
                        torch.cuda.current_stream(k.device).cuda_stream),
                     "flash_attention_kquant")
    cuda_build.LAUNCHES["flash_kquant"] += 1
    return qc, qs, codes, scales


def _forward(q, k, v, cond_start: int, mode: str, c_factor: Optional[float],
             rope: Rope, layout: str, save_residuals: bool,
             int8_attn: bool = False, block_k: Optional[int] = None,
             qk_rot: Optional[torch.Tensor] = None):
    """o, or (o, m2, l) with ``save_residuals``: the kernel on CUDA tensors,
    the plain versions on CPU tensors.  ``qk_rot``: `flash_rope`'s output
    for these q and k, which the wgmma route then reads instead of running
    the pre-pass."""
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}")
    if int8_attn and save_residuals:
        raise ValueError("flash_attention: the int8 score mode saves no "
                         "residuals (the backward rebuilds bf16 scores)")
    b, h, s, d, (sb, ss, sh) = _dims(q, layout)
    if q.device.type == "cpu":
        o = flash_attention_plain(q, k, v, cond_start=cond_start, mode=mode,
                                  c_factor=c_factor, rope=rope, layout=layout,
                                  int8_attn=int8_attn, block_k=block_k)
        if not save_residuals:
            return o
        return (o, *flash_residuals_plain(q, k, cond_start=cond_start,
                                          mode=mode, rope=rope, layout=layout))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda_qkv(q, (("q", q), ("k", k), ("v", v)), d)
    cos_p, sin_p = _cuda_rope(rope, s, d, q.device)
    cbias = 0.0
    if c_factor is not None:
        if save_residuals:
            raise ValueError("flash_attention: the c_factor mode saves no "
                             "residuals (its backward recomputes)")
        mode = "cfactor"
        cbias = float(np.log(np.float32(c_factor)))
    if int8_attn:
        return _forward_int8(q, k, v, cond_start, mode, cbias, rope, layout,
                             int8_key_span(s, block_k), (cos_p, sin_p))
    out = torch.empty_like(q)
    m2 = l = None
    if save_residuals:
        m2 = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
        l = torch.empty_like(m2)
    route = active_route(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = cuda_build.library("flash_attention")
    scale = _scales(d)[0]
    if route == "wgmma":
        qk, qk_strides = (q, k), (sb, ss, sh)
        if rope is not None:
            qk = flash_rope(q, k, rope, layout) if qk_rot is None else qk_rot
            qk_strides = (h * s * d, d, s * d)
        fn = lib.flash_attention_fwd_wgmma
        fn.argtypes, fn.restype = _WGMMA_SIGNATURE, ctypes.c_int
        code = fn(qk[0].data_ptr(), qk[1].data_ptr(), v.data_ptr(),
                  out.data_ptr(), _ptr(m2), _ptr(l), b, h, s, d, *qk_strides,
                  sb, ss, sh, cond_start, _MODE_IDS[mode], cbias, scale, stream)
    else:
        fn = lib.flash_attention_fwd
        fn.argtypes, fn.restype = _FWD_SIGNATURE, ctypes.c_int
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  cos_p, sin_p, _ptr(m2), _ptr(l), b, h, s, d, sb, ss, sh,
                  cond_start, _MODE_IDS[mode], cbias, scale, stream)
    cuda_build.check(code, f"flash_attention_fwd ({route})")
    cuda_build.LAUNCHES["flash_attention"] += 1
    cuda_build.LAUNCHES[f"flash_attention:{route}"] += 1
    return (out, m2, l) if save_residuals else out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _forward_int8(q, k, v, cond_start: int, mode: str, cbias: float,
                  rope: Rope, layout: str, span: int, rope_ptrs):
    """The int8 QK^T forward on CUDA tensors: the pre-pass, then the forward
    kernel of `flash_int8_route` (the wgmma one reads q's codes from the
    pre-pass; the mma.sync one quantizes q itself).  Each launch counts as
    ``flash_attention_int8`` and ``flash_attention_int8:<route>``."""
    b, h, s, d, (sb, ss, sh) = _dims(q, layout)
    out = torch.empty_like(q)
    route = active_int8_route(d, span)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (cond_start, _MODE_IDS[mode], cbias, _scales(d)[0], span)
    if route == "wgmma":
        qc, qs, codes, scales = flash_int8_prepass(q, k, span=span, rope=rope,
                                                   layout=layout)
        fn = cuda_build.entry("flash_attention",
                              "flash_attention_fwd_int8_wgmma",
                              _FWD_INT8_WGMMA_SIGNATURE)
        code = fn(qc.data_ptr(), qs.data_ptr(), codes.data_ptr(),
                  scales.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, d,
                  sb, ss, sh, *tail, scales.shape[-1], stream)
    else:
        codes, scales = flash_kquant(k, span=span, rope=rope, layout=layout)
        fn = cuda_build.entry("flash_attention", "flash_attention_fwd_int8",
                              _FWD_INT8_SIGNATURE)
        code = fn(q.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                  v.data_ptr(), out.data_ptr(), *rope_ptrs, b, h, s, d, sb, ss,
                  sh, *tail, scales.shape[-1], stream)
    cuda_build.check(code, f"flash_attention_fwd_int8 ({route})")
    cuda_build.LAUNCHES["flash_attention_int8"] += 1
    cuda_build.LAUNCHES[f"flash_attention_int8:{route}"] += 1
    return out


def flash_attention_bwd(q, k, v, do, m2, l, di, *, cond_start: int,
                        mode: str = "union", rope: Rope = None,
                        layout: str = "bhsd", need_dq: bool = True,
                        need_dkv: bool = True,
                        qk_rot: Optional[torch.Tensor] = None):
    """(dq, dk, dv) from the forward's inputs, its base-2 residuals (m2, l)
    and di = rowsum(o * do), all [B, H, S] float32.  On CUDA tensors the
    dK/dV and the dQ kernels of `flash_bwd_route` (each only if needed; a
    pass not run returns None); on CPU tensors `flash_attention_bwd_plain`.
    ``qk_rot``, `flash_rope`'s output for q and k, is the wgmma route's
    input with RoPE (made here when it is not given); with it q and k are
    not read and may be None, and the route must be wgmma."""
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}")
    b, h, s, d, (sb, ss, sh) = _dims(v, layout)
    if v.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, m2, l, di,
                                         cond_start=cond_start, mode=mode,
                                         rope=rope, layout=layout,
                                         qk_rot=qk_rot)
    route = active_route(d)
    if qk_rot is not None and route != "wgmma":
        raise ValueError("flash_attention backward: rotated q and k (qk_rot) "
                         "are the wgmma route's input, the route is "
                         f"{route!r}")
    if v.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {v.device}")
    _check_cuda_qkv(v, (("v", v), ("do", do)), d)
    if qk_rot is None:
        _check_cuda_qkv(v, (("q", q), ("k", k)), d)
    _stats_check(b, h, s, v.device, m2=m2, l=l, di=di)
    cos_p, sin_p = _cuda_rope(rope, s, d, v.device)
    lib = cuda_build.library("flash_attention")
    stream = torch.cuda.current_stream(v.device).cuda_stream
    stats = (m2.data_ptr(), l.data_ptr(), di.data_ptr(), cos_p, sin_p)
    tail = (cond_start, _MODE_IDS[mode], _scales(d)[0], stream)
    if route == "wgmma":
        qk, qk_strides = (q, k), (sb, ss, sh)
        if rope is not None:
            if qk_rot is None:
                qk_rot = flash_rope(q, k, rope, layout)
            if (qk_rot.dtype != torch.bfloat16 or qk_rot.shape != (2, b, h, s, d)
                    or not qk_rot.is_contiguous()):
                raise ValueError("flash_attention backward: qk_rot must be "
                                 f"contiguous bf16 [2, {b}, {h}, {s}, {d}]")
            qk, qk_strides = qk_rot, (h * s * d, d, s * d)
        head = (qk[0].data_ptr(), qk[1].data_ptr(), v.data_ptr(), do.data_ptr(),
                *stats)
        dims = (b, h, s, d, *qk_strides, sb, ss, sh, *tail)
        names = ("flash_attention_bwd_dkv_wgmma", "flash_attention_bwd_dq_wgmma")
        signatures = (_DKV_WGMMA_SIGNATURE, _DQ_WGMMA_SIGNATURE)
    else:
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *stats)
        dims = (b, h, s, d, sb, ss, sh, *tail)
        names = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")
        signatures = (_DKV_SIGNATURE, _DQ_SIGNATURE)
    dq = dk = dv = None
    if need_dkv:
        dk, dv = torch.empty_like(v), torch.empty_like(v)
        fn = getattr(lib, names[0])
        fn.argtypes, fn.restype = signatures[0], ctypes.c_int
        cuda_build.check(fn(*head, dk.data_ptr(), dv.data_ptr(), *dims),
                         names[0])
        cuda_build.LAUNCHES["flash_bwd_dkv"] += 1
        cuda_build.LAUNCHES[f"flash_bwd_dkv:{route}"] += 1
    if need_dq:
        dq = torch.empty_like(v)
        fn = getattr(lib, names[1])
        fn.argtypes, fn.restype = signatures[1], ctypes.c_int
        cuda_build.check(fn(*head, dq.data_ptr(), *dims), names[1])
        cuda_build.LAUNCHES["flash_bwd_dq"] += 1
        cuda_build.LAUNCHES[f"flash_bwd_dq:{route}"] += 1
    return dq, dk, dv


def _row_dot(o: torch.Tensor, do: torch.Tensor, layout: str) -> torch.Tensor:
    """di = rowsum(o * do) in float32, [B, H, S] in either layout."""
    di = (o.float() * do.float()).sum(-1)
    return di.transpose(1, 2).contiguous() if layout == "bshd" else di


# ---------------------------------------------------------------------------
# Differentiable entry point
# ---------------------------------------------------------------------------


class _FlashAttentionFn(torch.autograd.Function):
    """Mask modes: the forward kernel saves (m2, l); the backward runs the
    dK/dV and dQ kernels (each only when its gradients are needed).  On the
    wgmma route with RoPE the forward's pre-pass output (rotated q and k)
    is saved in place of q and k and is the backward kernels' input."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, cond_start, mode, layout):
        rope = None if cos is None else (cos, sin)
        qk_rot = None
        if (rope is not None and q.device.type == "cuda"
                and active_route(q.shape[-1]) == "wgmma"):
            qk_rot = flash_rope(q, k, rope, layout)
        o, m2, l = _forward(q, k, v, cond_start, mode, None, rope, layout,
                            save_residuals=True, qk_rot=qk_rot)
        if qk_rot is not None:
            q = k = None
        ctx.save_for_backward(q, k, v, o, m2, l, cos, sin, qk_rot)
        ctx.meta = (cond_start, mode, layout)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m2, l, cos, sin, qk_rot = ctx.saved_tensors
        cond_start, mode, layout = ctx.meta
        do = do.to(v.dtype).contiguous()
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq, dk, dv = flash_attention_bwd(
            q, k, v, do, m2, l, _row_dot(o, do, layout), cond_start=cond_start,
            mode=mode, rope=None if cos is None else (cos, sin), layout=layout,
            need_dq=need_q, need_dkv=need_k or need_v, qk_rot=qk_rot)
        return (dq if need_q else None, dk if need_k else None,
                dv if need_v else None, None, None, None, None, None)


class _FlashCFactorFn(torch.autograd.Function):
    """c_factor mode: the forward kernel, a plain float32 recompute backward
    (on every device)."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, cond_start, c_factor, layout):
        rope = None if cos is None else (cos, sin)
        ctx.save_for_backward(q, k, v, cos, sin)
        ctx.meta = (cond_start, c_factor, layout)
        return _forward(q, k, v, cond_start, "union", c_factor, rope, layout,
                        save_residuals=False)

    @staticmethod
    def backward(ctx, do):
        q, k, v, cos, sin = ctx.saved_tensors
        cond_start, c_factor, layout = ctx.meta
        dq, dk, dv = _cfactor_bwd_plain(
            q, k, v, do, cond_start, c_factor,
            None if cos is None else (cos, sin), layout)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, cond_start: int, mode: str = "union",
                    c_factor: Optional[float] = None, rope: Rope = None,
                    layout: str = "bhsd", int8_attn: bool = False,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Attention with condition block semantics; q/k/v [B, H, S, D] ("bhsd")
    or [B, S, H, D] ("bshd"), output in the same layout and dtype.
    Differentiable in q, k and v when grad is enabled, and then always with
    bf16 scores: ``int8_attn`` (int8 QK^T, k-scale span `int8_key_span`(S,
    ``block_k``)) applies to inference only."""
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}")
    cos, sin = rope if rope is not None else (None, None)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # int8 scores are forced off here, as in the JAX package: the
        # backward rebuilds the probabilities from bf16 scores
        s = _dims(q, layout)[2]
        if c_factor is not None and cond_start < s:
            return _FlashCFactorFn.apply(q, k, v, cos, sin, cond_start,
                                         c_factor, layout)
        return _FlashAttentionFn.apply(q, k, v, cos, sin, cond_start, mode,
                                       layout)
    return _forward(q, k, v, cond_start, mode, c_factor, rope, layout,
                    save_residuals=False, int8_attn=int8_attn, block_k=block_k)
