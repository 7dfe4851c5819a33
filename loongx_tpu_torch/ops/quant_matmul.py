"""int8-weight matmuls: y = x @ Wq * scale (+ bias) (+ gelu_tanh), their
transposed products dx = (dy * scale) @ Wq^T, and the autograd Functions
that train LoRA against the frozen int8 base (QLoRA).

Counterpart of ``loongx_tpu/ops/quant_matmul.py``.  Forward contracts:

  * `quant_matmul` -- flat ``[K, N]`` weight (``quant_matmul`` /
    ``quant_matmul_w8a8``, TPU kernel ``_qmm_kernel``);
  * `quant_matmul_stacked` -- block ``blk`` of an ``[NB, K, N]`` stack
    (TPU kernel ``_qmm_stacked_kernel``); the stack is never sliced into a
    copy, the kernel takes ``blk`` as a pointer offset;
  * `quant_qkv_stacked` -- the fused ``[K, 3H]`` qkv projection with per-head
    RMS on q and k, written as ``[3, M, H]`` planes (TPU kernel
    ``_qmm_qkv_stacked_kernel``).

Backward contracts (TPU kernels ``_qmm_t_kernel`` / ``_qmm_t_stacked_kernel``,
CUDA kernel ``csrc/quant_matmul_t.cu``):

  * `quant_matmul_t` / `quant_matmul_t_stacked` -- dx[m, k] = sum_n
    cast(dy[m, n] * scale[n]) * Wq[k, n] with the weight in its stored
    [K, N] layout (block ``blk`` of a stack by pointer offset).

The forward and transposed kernels run on CUDA tensors and their plain
versions on CPU tensors; nothing falls back.
In W8A8 mode the GEMM is preceded by `act_quant`, a small kernel of the
same source that quantizes the activations.

Two MAC modes, chosen by ``w8a8``:

  * weight-only: the kernel computes on bf16 activations (the TPU kernel
    casts x to bf16) with the int8 weight widened exactly to bf16 and an
    fp32 accumulator, and writes bf16.  The plain version multiplies x as
    given in float32 and returns x's dtype, so for float32 inputs it is
    the JAX package's XLA dequant path;
  * W8A8: bf16(x) is quantized per (row, k-group) -- x_scale = absmax/127
    (1 when absmax == 0), q = clip(rint(x / x_scale), -127, 127) -- each
    group's s8 x s8 product is rescaled into an fp32 accumulator, and the
    output is bf16 on every device.  The group is the TPU kernel's k tile,
    copied exactly: `stacked_w8a8_group` / `flat_w8a8_group`.

The epilogue is fp32: z = acc * scale, + bias, then gelu_tanh, then one cast.

The transposed product rounds dy * scale (fp32) to dy's dtype before the
contraction, as the TPU kernel rounds it to bf16, and sums in fp32; for
bf16 dy that is the CUDA kernel exactly, for float32 dy the JAX package's
XLA transpose of its dequant path.

Autograd (the JAX custom VJPs): `quant_matmul_vjp`,
`quant_matmul_stacked_vjp`, `quant_linear_gelu_stacked` and
`quant_linear_gelu` are differentiable in x only.  The frozen int8 weight,
scale and bias get no gradient, and no dx is computed when x needs none
(``ctx.needs_input_grad``).  The gelu variants recompute the pre-activation
in their backward, as the JAX package does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from loongx_tpu_torch.ops import cuda_build

EPI_BIAS, EPI_GELU, EPI_QKV = 0, 1, 2
_P, _I = ctypes.c_void_p, ctypes.c_int
_GEMM_SIGNATURE = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _I, _I, _P]
_QUANT_SIGNATURE = [_P, _I, _I, _I, _I, _P, _P, _P]
_T_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _P]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# W8A8 group policy: the TPU kernels' k tile (their activation-scale group)
# ---------------------------------------------------------------------------


def flat_w8a8_group(k: int, n: int) -> Tuple[int, int]:
    """(group, padded K) of the flat W8A8 kernel (quant_matmul_w8a8:341-344
    and _qmm_flat): 1024 when N >= 4K else 1536, clamped to round_up(K,
    128); K is zero-padded to a multiple of the group."""
    group = 1024 if n >= 4 * k else 1536
    group = min(group, _round_up(k, 128))
    return group, _round_up(k, group)


def _stacked_blocks(k: int, n: int) -> Tuple[int, int]:
    """(block_n, block_k) of the stacked TPU kernels (_stacked_blocks)."""
    wide_n = n >= 4 * k
    for bn in (3072, 1536, 2048, 2560, 1280):
        if n % bn == 0:
            block_n = bn
            break
    else:
        block_n = 2048 if wide_n else 1024
    for bk in (3072, 2048, 2560, 1280):
        if k % bk == 0:
            return block_n, bk
    return block_n, (1024 if wide_n else 1536)


def stacked_w8a8_group(k: int, n: int) -> Tuple[int, int]:
    """(group, padded K) of the stacked W8A8 kernel: its k tile (3072 at
    every FLUX shape, K = 12288 included); shapes the stacked tiling cannot
    cover take the flat kernel's policy, as the TPU path falls back."""
    block_n, block_k = _stacked_blocks(k, n)
    block_n, block_k = min(block_n, n), min(block_k, k)
    if k % block_k == 0 and n % block_n == 0:
        return block_k, k
    return flat_w8a8_group(k, n)


def qkv_supported(k: int, n3: int, head_dim: int) -> bool:
    """Can the fused-qkv kernel take this shape (quant_qkv_stacked)?"""
    h = n3 // 3
    block_k = min(_stacked_blocks(k, n3)[1], k)
    return n3 % 3 == 0 and h % head_dim == 0 and k % block_k == 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def act_quant_plain(x: torch.Tensor, group: int,
                    k_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16(x) [M, K] -> (q float32 [M, k_pad] integer-valued, x_scale
    float32 [M, k_pad // group])."""
    xf = F.pad(x.to(torch.bfloat16).float(), (0, k_pad - x.shape[1]))
    xg = xf.view(x.shape[0], k_pad // group, group)
    absmax = xg.abs().amax(-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the true quotient in the last bit
    xs = torch.where(absmax == 0, torch.ones_like(absmax),
                     absmax / absmax.new_full((), 127.0))
    q = torch.clamp(torch.round(xg / xs[..., None]), -127, 127)
    return q.view(x.shape[0], k_pad), xs


def _plain_acc(x, w_q, scale, bias, w8a8: bool, group: int, k_pad: int):
    """(z = acc * scale + bias in float32, output dtype) of the plain MAC:
    per-group s8 products (integer-valued float32 matmuls) rescaled into
    the accumulator for W8A8, x @ w in float32 for weight-only."""
    if w8a8:
        xq, xs = act_quant_plain(x, group, k_pad)
        wf = F.pad(w_q.float(), (0, 0, 0, k_pad - w_q.shape[0]))
        acc = torch.zeros(x.shape[0], w_q.shape[1], dtype=torch.float32,
                          device=x.device)
        for gi in range(k_pad // group):
            part = slice(gi * group, (gi + 1) * group)
            acc = acc + torch.matmul(xq[:, part], wf[part]) * xs[:, gi:gi + 1]
        out_dtype = torch.bfloat16
    else:
        acc = torch.matmul(x.float(), w_q.float())
        out_dtype = x.dtype
    z = acc * scale.reshape(-1).float()
    if bias is not None:
        z = z + bias.reshape(-1).float()
    return z, out_dtype


def qmm_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              activation: Optional[str] = None, w8a8: bool = False,
              group: int = 0, k_pad: int = 0) -> torch.Tensor:
    """Plain version of the kernel on a [K, N] weight (a view of a stack is
    fine): x [M, K]; scale/bias broadcastable to [N]."""
    z, out_dtype = _plain_acc(x, w_q, scale, bias, w8a8, group, k_pad)
    if activation == "gelu_tanh":
        z = F.gelu(z, approximate="tanh")
    elif activation is not None:
        raise ValueError(f"unknown fused activation {activation!r}")
    return z.to(out_dtype)


def rms_heads_plain(z: torch.Tensor, head_dim: int,
                    weight: torch.Tensor) -> torch.Tensor:
    """Per-head RMS (eps 1e-6) of float32 z [M, H] times weight [H]."""
    zg = z.unflatten(-1, (-1, head_dim))
    zg = zg * torch.rsqrt(zg.square().mean(-1, keepdim=True) + 1e-6)
    return zg.flatten(-2) * weight.float()


def quant_qkv_plain(x, w_q, scale, bias, norm_w, head_dim: int,
                    w8a8: bool = False, group: int = 0, k_pad: int = 0):
    """Plain version of the fused-qkv kernel on a [K, 3H] weight: the RMS
    epilogue runs on the float32 z, before the one cast."""
    z, out_dtype = _plain_acc(x, w_q, scale, bias, w8a8, group, k_pad)
    q, k, v = z.chunk(3, dim=-1)
    q = rms_heads_plain(q, head_dim, norm_w[0])
    k = rms_heads_plain(k, head_dim, norm_w[1])
    return q.to(out_dtype), k.to(out_dtype), v.to(out_dtype)


def qmm_t_plain(dy: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the transposed kernel on a [K, N] weight (a view of
    a stack is fine): dy [M, N], scale broadcastable to [N] -> dx [M, K] in
    dy's dtype."""
    a = (dy.float() * scale.reshape(-1).float()).to(dy.dtype).float()
    return torch.matmul(a, w_q.float().t()).to(dy.dtype)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def act_quant(x: torch.Tensor, group: int,
              k_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The W8A8 activation pass: bf16(x) [M, K] -> (int8 [M, k_pad], float32
    x_scale [M, k_pad // group]), K zero-padded to k_pad.  Launches
    ``act_quant_kernel`` on a CUDA tensor; `act_quant_plain` on CPU."""
    if x.device.type == "cpu":
        q, xs = act_quant_plain(x, group, k_pad)
        return q.to(torch.int8), xs
    m, k = x.shape
    x = _cuda_x(x, k)
    _check(group % 64 == 0 and k_pad % group == 0 and k <= k_pad,
           f"W8A8 kernel: group {group} must be a multiple of 64 dividing "
           f"k_pad {k_pad} >= K {k}")
    a = torch.empty(m, k_pad, dtype=torch.int8, device=x.device)
    xs = torch.empty(m, k_pad // group, dtype=torch.float32, device=x.device)
    fn = cuda_build.library("quant_matmul").qmm_act_quant
    fn.argtypes, fn.restype = _QUANT_SIGNATURE, ctypes.c_int
    cuda_build.check(fn(x.data_ptr(), m, k, group, k_pad // group, a.data_ptr(),
                        xs.data_ptr(),
                        torch.cuda.current_stream(x.device).cuda_stream),
                     "qmm_act_quant")
    cuda_build.LAUNCHES["qmm_act_quant"] += 1
    return a, xs


def _launch(name: str, x, w_ptr: int, k: int, n: int, scale_ptr: int,
            bias_ptr: Optional[int], epilogue: int, w8a8: bool, group: int,
            k_pad: int, out: torch.Tensor, norm_w_ptr: Optional[int] = None,
            head_dim: int = 0, plane_h: int = 0) -> None:
    m = x.shape[0]
    lib = cuda_build.library("quant_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xs = None
    if w8a8:
        a, xs = act_quant(x, group, k_pad)
    else:
        _check(k % 8 == 0, f"weight-only kernel: K {k} not a multiple of 8")
        a = x
    fn = lib.qmm_gemm
    fn.argtypes, fn.restype = _GEMM_SIGNATURE, ctypes.c_int
    code = fn(int(w8a8), epilogue, a.data_ptr(),
              None if xs is None else xs.data_ptr(), w_ptr, scale_ptr, bias_ptr,
              norm_w_ptr, out.data_ptr(), m, k, k_pad, n, group,
              k_pad // group if w8a8 else 0, head_dim, plane_h, stream)
    cuda_build.check(code, f"qmm_gemm ({name})")
    cuda_build.LAUNCHES[name] += 1


def _cuda_x(x: torch.Tensor, k: int) -> torch.Tensor:
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(x.ndim == 2 and x.shape[1] == k,
           f"x must be [M, {k}], got {tuple(x.shape)}")
    _check(x.is_floating_point(), f"x must be floating point, got {x.dtype}")
    return x.to(torch.bfloat16).contiguous()


def _cuda_vec(t: Optional[torch.Tensor], shape, what: str, device):
    if t is None:
        return None
    _check(t.dtype == torch.float32 and t.is_contiguous() and t.device == device
           and tuple(t.shape) == tuple(shape),
           f"{what} must be contiguous float32 {tuple(shape)} on {device}, got "
           f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t


def _cuda_weight(w: torch.Tensor, device):
    _check(w.dtype == torch.int8 and w.is_contiguous() and w.device == device,
           f"weight must be contiguous int8 on {device}, got {w.dtype} on "
           f"{w.device}")
    _check(w.shape[-1] % 16 == 0, f"N {w.shape[-1]} not a multiple of 16")


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None,
                 w8a8: bool = False) -> torch.Tensor:
    """x [M, K] @ w_q [K, N] int8 * scale [1, N] (+ bias [1, N]) (+ gelu)."""
    k, n = w_q.shape
    group, k_pad = flat_w8a8_group(k, n)
    if x.device.type == "cpu":
        return qmm_plain(x, w_q, scale, bias, activation, w8a8, group, k_pad)
    x = _cuda_x(x, k)
    _cuda_weight(w_q, x.device)
    _cuda_vec(scale, (1, n), "scale", x.device)
    _cuda_vec(bias, (1, n), "bias", x.device)
    out = torch.empty(x.shape[0], n, dtype=torch.bfloat16, device=x.device)
    _launch("qmm_flat", x, w_q.data_ptr(), k, n, scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            EPI_GELU if activation == "gelu_tanh" else EPI_BIAS, w8a8, group,
            k_pad, out)
    return out


def _stack_ptr(t: torch.Tensor, blk: int) -> int:
    return t.data_ptr() + blk * t[0].numel() * t.element_size()


def quant_matmul_stacked(x: torch.Tensor, w_q3: torch.Tensor,
                         scale3: torch.Tensor, blk: int, *,
                         bias3: Optional[torch.Tensor] = None,
                         activation: Optional[str] = None,
                         w8a8: bool = False) -> torch.Tensor:
    """x [M, K] @ w_q3[blk] ([NB, K, N] int8) * scale3[blk] ([NB, 1, N])
    (+ bias3[blk]) (+ gelu)."""
    nb, k, n = w_q3.shape
    if not 0 <= blk < nb:
        raise IndexError(f"block {blk} out of range for a stack of {nb}")
    group, k_pad = stacked_w8a8_group(k, n)
    if x.device.type == "cpu":
        return qmm_plain(x, w_q3[blk], scale3[blk],
                         None if bias3 is None else bias3[blk], activation,
                         w8a8, group, k_pad)
    x = _cuda_x(x, k)
    _cuda_weight(w_q3, x.device)
    _cuda_vec(scale3, (nb, 1, n), "scale", x.device)
    _cuda_vec(bias3, (nb, 1, n), "bias", x.device)
    out = torch.empty(x.shape[0], n, dtype=torch.bfloat16, device=x.device)
    _launch("qmm_stacked", x, _stack_ptr(w_q3, blk), k, n,
            _stack_ptr(scale3, blk),
            None if bias3 is None else _stack_ptr(bias3, blk),
            EPI_GELU if activation == "gelu_tanh" else EPI_BIAS, w8a8, group,
            k_pad, out)
    return out


def quant_qkv_stacked(x: torch.Tensor, w_q3: torch.Tensor,
                      scale3: torch.Tensor, bias3: torch.Tensor,
                      norm_w: torch.Tensor, blk: int, head_dim: int, *,
                      w8a8: bool = False):
    """(q, k, v), each [M, H]: one matmul over the fused [NB, K, 3H] weight,
    per-head RMS (eps 1e-6) times norm_w[0] / norm_w[1] on q / k, v as is.
    norm_w: [3, H] float32."""
    nb, k, n3 = w_q3.shape
    if not 0 <= blk < nb:
        raise IndexError(f"block {blk} out of range for a stack of {nb}")
    h = n3 // 3
    if not qkv_supported(k, n3, head_dim):
        # the TPU path's fallback: plain matmul kernel, then split + RMS
        y = quant_matmul_stacked(x, w_q3, scale3, blk, bias3=bias3,
                                 w8a8=w8a8).float()
        q, kk, v = y.chunk(3, dim=-1)
        return (rms_heads_plain(q, head_dim, norm_w[0]).to(torch.bfloat16),
                rms_heads_plain(kk, head_dim, norm_w[1]).to(torch.bfloat16),
                v.to(torch.bfloat16))
    group, k_pad = stacked_w8a8_group(k, n3)
    if x.device.type == "cpu":
        return quant_qkv_plain(x, w_q3[blk], scale3[blk], bias3[blk], norm_w,
                               head_dim, w8a8, group, k_pad)
    x = _cuda_x(x, k)
    _cuda_weight(w_q3, x.device)
    _cuda_vec(scale3, (nb, 1, n3), "scale", x.device)
    _cuda_vec(bias3, (nb, 1, n3), "bias", x.device)
    _cuda_vec(norm_w, (3, h), "norm_w", x.device)
    _check(h % 128 == 0, f"qkv kernel: H {h} not a multiple of 128")
    _check(head_dim in (32, 64, 128), f"qkv kernel: head_dim {head_dim}")
    out = torch.empty(3, x.shape[0], h, dtype=torch.bfloat16, device=x.device)
    _launch("qmm_qkv_stacked", x, _stack_ptr(w_q3, blk), k, n3,
            _stack_ptr(scale3, blk), _stack_ptr(bias3, blk), EPI_QKV, w8a8,
            group, k_pad, out, norm_w_ptr=norm_w.data_ptr(),
            head_dim=head_dim, plane_h=h)
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# Transposed products (the backward of the int8 linears)
# ---------------------------------------------------------------------------


def _launch_t(name: str, dy: torch.Tensor, w_ptr: int, k: int, n: int,
              scale_ptr: int) -> torch.Tensor:
    dy = dy.to(torch.bfloat16).contiguous()
    _check(n % 16 == 0 and k % 2 == 0,
           f"transposed kernel: N {n} must be a multiple of 16, K {k} even")
    out = torch.empty(dy.shape[0], k, dtype=torch.bfloat16, device=dy.device)
    fn = cuda_build.library("quant_matmul_t").qmm_t_gemm
    fn.argtypes, fn.restype = _T_SIGNATURE, ctypes.c_int
    cuda_build.check(fn(dy.data_ptr(), w_ptr, scale_ptr, out.data_ptr(),
                        dy.shape[0], k, n,
                        torch.cuda.current_stream(dy.device).cuda_stream),
                     f"qmm_t_gemm ({name})")
    cuda_build.LAUNCHES[name] += 1
    return out


def _cuda_dy(dy: torch.Tensor, n: int) -> None:
    _check(dy.device.type == "cuda", f"unsupported device {dy.device}")
    _check(dy.ndim == 2 and dy.shape[1] == n,
           f"dy must be [M, {n}], got {tuple(dy.shape)}")
    _check(dy.is_floating_point(), f"dy must be floating point, got {dy.dtype}")


def quant_matmul_t(dy: torch.Tensor, w_q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """dx = cast(dy * scale) @ w_q^T: dy [M, N], w_q [K, N] int8, scale
    [1, N] -> [M, K] (bf16 from the kernel, dy's dtype from the plain
    version)."""
    k, n = w_q.shape
    if dy.device.type == "cpu":
        return qmm_t_plain(dy, w_q, scale)
    _cuda_dy(dy, n)
    _cuda_weight(w_q, dy.device)
    _cuda_vec(scale, (1, n), "scale", dy.device)
    return _launch_t("qmm_t", dy, w_q.data_ptr(), k, n, scale.data_ptr())


def quant_matmul_t_stacked(dy: torch.Tensor, w_q3: torch.Tensor,
                           scale3: torch.Tensor, blk: int) -> torch.Tensor:
    """dx = cast(dy * scale3[blk]) @ w_q3[blk]^T without slicing the stack:
    dy [M, N], w_q3 [NB, K, N] int8, scale3 [NB, 1, N] -> [M, K]."""
    nb, k, n = w_q3.shape
    if not 0 <= blk < nb:
        raise IndexError(f"block {blk} out of range for a stack of {nb}")
    if dy.device.type == "cpu":
        return qmm_t_plain(dy, w_q3[blk], scale3[blk])
    _cuda_dy(dy, n)
    _cuda_weight(w_q3, dy.device)
    _cuda_vec(scale3, (nb, 1, n), "scale", dy.device)
    return _launch_t("qmm_t_stacked", dy, _stack_ptr(w_q3, blk), k, n,
                     _stack_ptr(scale3, blk))


# ---------------------------------------------------------------------------
# Autograd Functions (the JAX custom VJPs)
# ---------------------------------------------------------------------------


def _gelu_grad(dy: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """d gelu_tanh(z) * dy in float32, cast to dy's dtype."""
    return torch.ops.aten.gelu_backward(dy.float(), z.float(),
                                        approximate="tanh").to(dy.dtype)


class _QuantMatmulFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q, scale, w8a8):
        ctx.save_for_backward(w_q, scale)
        ctx.x_dtype = x.dtype
        return quant_matmul(x, w_q, scale, w8a8=w8a8)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        w_q, scale = ctx.saved_tensors
        return quant_matmul_t(dy, w_q, scale).to(ctx.x_dtype), None, None, None


class _QuantMatmulStackedFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q3, scale3, blk, w8a8):
        ctx.save_for_backward(w_q3, scale3)
        ctx.blk, ctx.x_dtype = blk, x.dtype
        return quant_matmul_stacked(x, w_q3, scale3, blk, w8a8=w8a8)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        w_q3, scale3 = ctx.saved_tensors
        dx = quant_matmul_t_stacked(dy, w_q3, scale3, ctx.blk)
        return dx.to(ctx.x_dtype), None, None, None, None


class _QuantLinearGeluStackedFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q3, scale3, bias3, blk, w8a8):
        ctx.save_for_backward(x if ctx.needs_input_grad[0] else None, w_q3,
                              scale3, bias3)
        ctx.blk, ctx.w8a8 = blk, w8a8
        return quant_matmul_stacked(x, w_q3, scale3, blk, bias3=bias3,
                                    activation="gelu_tanh", w8a8=w8a8)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        x, w_q3, scale3, bias3 = ctx.saved_tensors
        z = quant_matmul_stacked(x, w_q3, scale3, ctx.blk, bias3=bias3,
                                 w8a8=ctx.w8a8)  # recompute pre-activation
        dx = quant_matmul_t_stacked(_gelu_grad(dy, z), w_q3, scale3, ctx.blk)
        return dx.to(x.dtype), None, None, None, None, None


class _QuantLinearGeluFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q, scale, bias, w8a8):
        ctx.save_for_backward(x if ctx.needs_input_grad[0] else None, w_q,
                              scale, bias)
        ctx.w8a8 = w8a8
        return quant_matmul(x, w_q, scale, bias=bias, activation="gelu_tanh",
                            w8a8=w8a8)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        x, w_q, scale, bias = ctx.saved_tensors
        z = quant_matmul(x, w_q, scale, bias=bias, w8a8=ctx.w8a8)
        dx = quant_matmul_t(_gelu_grad(dy, z), w_q, scale)
        return dx.to(x.dtype), None, None, None, None


def quant_matmul_vjp(x, w_q, scale, *, w8a8: bool = False):
    """`quant_matmul`, differentiable in x (backward: `quant_matmul_t`)."""
    return _QuantMatmulFn.apply(x, w_q, scale, w8a8)


def quant_matmul_stacked_vjp(x, w_q3, scale3, blk: int, *, w8a8: bool = False):
    """`quant_matmul_stacked`, differentiable in x (backward:
    `quant_matmul_t_stacked`)."""
    return _QuantMatmulStackedFn.apply(x, w_q3, scale3, blk, w8a8)


def quant_linear_gelu_stacked(x, w_q3, scale3, bias3, blk: int, *,
                              w8a8: bool = False):
    """gelu_tanh(x @ w_q3[blk] * scale3[blk] + bias3[blk]) with the fused
    epilogue, differentiable in x (recompute backward)."""
    return _QuantLinearGeluStackedFn.apply(x, w_q3, scale3, bias3, blk, w8a8)


def quant_linear_gelu(x, w_q, scale, bias, *, w8a8: bool = False):
    """gelu_tanh(x @ w_q * scale + bias) with the fused epilogue (bias
    [1, N] float32), differentiable in x (recompute backward)."""
    return _QuantLinearGeluFn.apply(x, w_q, scale, bias, w8a8)
