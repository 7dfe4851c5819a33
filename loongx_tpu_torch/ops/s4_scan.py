"""The S4D recurrence as a kernel: ``s4_stack_apply(..., mode="pallas")``.

Counterpart of ``loongx_tpu/ops/s4_pallas.py`` (the TPU kernel
``_s4d_scan_kernel``, the streaming form of the CS3 encoders' S4D core).  The
mode keeps its JAX name so that configurations carry across; here it means
this module: on CUDA tensors `s4d_scan_recurrent` launches the hand-written
kernel in ``csrc/s4d_scan.cu``, on CPU tensors it runs `s4d_scan_plain`.
There is no fallback between the two.  The plain version is
``ops.s4.s4d_scan`` (the "scan" mode), re-exported here as `s4d_scan_plain`.

Both discretise in plain PyTorch (`ops.s4.discretise_real`, as the TPU path
does outside its kernel) and run, per batch element, channel h and state n,

    x_t = Abar x_{t-1} + Bbar u_t,   y_t = 2 sum_n (C_r x_r - C_i x_i)_t + D u_t

in float32 with u cast to float32, returning y in u's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from loongx_tpu_torch.ops import cuda_build
from loongx_tpu_torch.ops.nn import Params
from loongx_tpu_torch.ops.s4 import (  # s4d_scan: the kernel's plain version
    discretise_real, s4d_scan as s4d_scan_plain,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P] * 9 + [_I, _I, _I, _I, _P]


def s4d_scan_recurrent(p: Params, u: torch.Tensor) -> torch.Tensor:
    """u [B, L, H] -> y [B, L, H] in u's dtype through the recurrence: the
    CUDA kernel on a CUDA tensor, `s4d_scan_plain` on a CPU tensor."""
    if u.device.type == "cpu":
        return s4d_scan_plain(p, u)
    if u.device.type != "cuda":
        raise ValueError(f"s4d_scan: unsupported device {u.device}")
    if u.ndim != 3:
        raise ValueError(f"s4d_scan: u must be [B, L, H], got {tuple(u.shape)}")
    b, length, h = u.shape
    ar, ai, br, bi, cr, ci = (t.float().contiguous() for t in discretise_real(p))
    d = p["D"].float().contiguous()
    if ar.device != u.device:
        raise ValueError(f"s4d_scan: parameters on {ar.device}, u on {u.device}")
    n = ar.shape[1]
    if ar.shape != (h, n) or d.shape != (h,) or not 1 <= n <= 128:
        raise ValueError(f"s4d_scan: planes {tuple(ar.shape)} and D "
                         f"{tuple(d.shape)} do not fit u's H {h} (N <= 128)")
    uf = u.float().contiguous()
    y = torch.empty_like(uf)
    fn = cuda_build.library("s4d_scan").s4d_scan
    fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
    code = fn(uf.data_ptr(), ar.data_ptr(), ai.data_ptr(), br.data_ptr(),
              bi.data_ptr(), cr.data_ptr(), ci.data_ptr(), d.data_ptr(),
              y.data_ptr(), b, length, h, n,
              torch.cuda.current_stream(u.device).cuda_stream)
    cuda_build.check(code, "s4d_scan")
    cuda_build.LAUNCHES["s4d_scan"] += 1
    return y.to(u.dtype)
