"""The S4D recurrence as a kernel: ``s4_stack_apply(..., mode="pallas")``.

Counterpart of ``loongx_tpu/ops/s4_pallas.py`` (the TPU kernel
``_s4d_scan_kernel``, the streaming form of the CS3 encoders' S4D core).  The
mode keeps its JAX name so that configurations carry across; here it means
this module: on CUDA tensors `s4d_scan_recurrent` launches a hand-written
kernel of ``csrc/s4d_scan.cu``, on CPU tensors it runs `s4d_scan_plain`.
There is no fallback between the two.  The plain version is
``ops.s4.s4d_scan`` (the "scan" mode), re-exported here as `s4d_scan_plain`.

Both compute, per batch element, channel h and state n,

    x_t = Abar x_{t-1} + Bbar u_t,   y_t = 2 sum_n (C_r x_r - C_i x_i)_t + D u_t

in float32, returning y in u's dtype.  The kernel is the chunked scan
(``s4d_chunk_scan_kernel``, one launch a layer): it discretises in its
prologue with `ops.s4.discretise_real`'s operations, reads u and writes y
as they are on float32 (the encoders' dtype; other dtypes go through a
float32 copy), and cuts the recurrence into chunks that `s4d_chunk_plan`
sizes.  Under
`cuda_build.mma_sync_only` the first, sequential kernel (``s4d_scan_kernel``)
runs instead, after `discretise_real` in PyTorch and on float32 copies, to
time it beside.  Each launch counts as ``s4d_scan`` and
``s4d_scan:chunked`` / ``s4d_scan:sequential``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from loongx_tpu_torch.ops import cuda_build
from loongx_tpu_torch.ops.nn import Params
from loongx_tpu_torch.ops.s4 import (  # s4d_scan: the kernel's plain version
    discretise_real, s4d_scan as s4d_scan_plain,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P] * 9 + [_I, _I, _I, _I, _P]
_CHUNK_SIGNATURE = [_P] * 7 + [_I] * 11 + [_P]

S4D_MAX_N = 128  # states a channel: NQ lanes of at most S4D_MAX_Q
S4D_MAX_Q = 8  # states a lane
S4D_MAX_HB = 16  # channels a block where one lane holds a channel
S4D_BLOCK_U = 4096  # values of u a block stages at most, where it can hold fewer
S4D_MAX_THREADS = 512  # CS_MAX_THREADS: a lane's states and parameters in registers
SMEM_PER_BLOCK = 232448  # the dynamic shared memory a block may take (227 KB)


@dataclass(frozen=True)
class ChunkPlan:
    """How the chunked scan cuts a layer: ``C`` chunks of ``T`` steps (the
    last one ragged where T does not divide L); a block takes ``hb``
    channels of one batch element (``cl`` 2: half of one channel's chunks,
    the other half in the second block of its cluster) with ``threads``
    threads (a lane each and one each of its ``hb`` q nq states, whole
    warps), ``nq`` lanes a (chunk, channel) and ``q`` states a lane;
    ``smem`` bytes of shared memory a block."""
    T: int
    C: int
    hb: int
    nq: int
    q: int
    cl: int
    threads: int
    smem: int


def _smem(t: int, cc: int, hb: int, np_: int) -> int:
    """``cs_smem_bytes`` of a block of ``cc`` chunks: u with a padding step
    a chunk, the chunks' end states (complex), each state's Abar and C
    Bbar, and the end state of the cluster's block before (complex)."""
    return 4 * (cc * (t + 1) * hb + 2 * cc * hb * np_ + 6 * hb * np_)


def s4d_chunk_plan(length: int, h: int, n: int) -> ChunkPlan:
    """The chunked scan's cut of a [*, L, H] layer of N states a channel.

    The lanes: a channel's states go to ``nq`` lanes (1 where N <= 8, else
    the power of two that leaves each lane at most 8), ``q`` = ceil(N / nq)
    states a lane.  A block takes ``hb`` channels: 1 where a channel needs
    several lanes (its work fills more than an SM: a cluster of two blocks
    then splits its chunks, ``cl`` 2), else up to 16 and as many as keep
    its u within 4096 values (one SM's loads and stores bound a long
    layer).  The chunks: the power
    of two C0 (C0 hb nq / cl threads at most the block's limit) that
    minimises the dependent chain 2 T + C, T = ceil(L / C0), C = ceil(L /
    T), the smaller C on a tie (cl stays 2 only where C is even); hb halves
    until the shared memory fits.  The threads: one a lane, and at least
    one a state of the block (its prologue and walk; more than the lanes
    only where a short L gives fewer chunks than q).  Raises ValueError for N above 128 or an
    L no block can hold."""
    if not (length >= 1 and h >= 1 and 1 <= n <= S4D_MAX_N):
        raise ValueError(f"s4d_chunk_plan: L {length}, H {h}, N {n} (N 1..128)")
    nq = 1
    while -(-n // nq) > S4D_MAX_Q:
        nq *= 2
    q = -(-n // nq)
    hb = max(1, min(h, S4D_MAX_HB, S4D_BLOCK_U // length)) if nq == 1 else 1
    cl = 1 if nq == 1 else 2
    while True:
        best = None
        c0 = 1
        while c0 <= length and c0 * hb * nq <= S4D_MAX_THREADS * cl:
            t = -(-length // c0)
            c = -(-length // t)
            key = (2 * t + c, c)
            if best is None or key < best[0]:
                best = (key, t, c)
            c0 *= 2
        _, t, c = best
        cl = cl if c % cl == 0 else 1
        smem = _smem(t, c // cl, hb, q * nq)
        if smem <= SMEM_PER_BLOCK:
            threads = -(-max(c // cl, q) * hb * nq // 32) * 32
            return ChunkPlan(t, c, hb, nq, q, cl, threads, smem)
        if hb == 1:
            raise ValueError(f"s4d_chunk_plan: L {length} does not fit a "
                             f"block's shared memory ({smem} bytes)")
        hb //= 2


def _check_layer(p: Params, u: torch.Tensor):
    if u.ndim != 3:
        raise ValueError(f"s4d_scan: u must be [B, L, H], got {tuple(u.shape)}")
    h = u.shape[2]
    n = p["log_A_real"].shape[-1]
    shapes = {"log_A_real": (h, n), "A_imag": (h, n), "log_dt": (h,),
              "C": (h, n, 2), "D": (h,)}
    for name, shape in shapes.items():
        t = p[name]
        if tuple(t.shape) != shape or t.device != u.device:
            raise ValueError(f"s4d_scan: {name} {tuple(t.shape)} on {t.device}, "
                             f"want {shape} on {u.device} (u {tuple(u.shape)})")
    if not 1 <= n <= S4D_MAX_N:
        raise ValueError(f"s4d_scan: N {n} (1..{S4D_MAX_N})")
    return n


def _sequential(p: Params, u: torch.Tensor) -> torch.Tensor:
    """The first kernel (``s4d_scan_kernel``) after `discretise_real` in
    PyTorch, on float32 copies."""
    b, length, h = u.shape
    ar, ai, br, bi, cr, ci = (t.float().contiguous() for t in discretise_real(p))
    d = p["D"].float().contiguous()
    n = ar.shape[1]
    uf = u.float().contiguous()
    y = torch.empty_like(uf)
    fn = cuda_build.entry("s4d_scan", "s4d_scan", _SIGNATURE)
    cuda_build.check(fn(uf.data_ptr(), ar.data_ptr(), ai.data_ptr(), br.data_ptr(),
                        bi.data_ptr(), cr.data_ptr(), ci.data_ptr(), d.data_ptr(),
                        y.data_ptr(), b, length, h, n,
                        torch.cuda.current_stream(u.device).cuda_stream),
                     "s4d_scan (sequential)")
    return y.to(u.dtype)


def _chunked(p: Params, u: torch.Tensor, n: int) -> torch.Tensor:
    """The chunked kernel (``s4d_chunk_scan_kernel``)."""
    b, length, h = u.shape
    plan = s4d_chunk_plan(length, h, n)
    x = u.float().contiguous()
    y = torch.empty_like(x)
    planes = [p[k].float().contiguous()
              for k in ("log_A_real", "A_imag", "log_dt", "C", "D")]
    fn = cuda_build.entry("s4d_scan", "s4d_chunk_scan", _CHUNK_SIGNATURE)
    cuda_build.check(fn(x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in planes),
                        b, length, h, n,
                        plan.T, plan.C, plan.hb, plan.nq, plan.q, plan.cl, plan.threads,
                        torch.cuda.current_stream(u.device).cuda_stream),
                     "s4d_scan (chunked)")
    return y.to(u.dtype)


def s4d_scan_recurrent(p: Params, u: torch.Tensor) -> torch.Tensor:
    """u [B, L, H] -> y [B, L, H] in u's dtype through the recurrence: the
    chunked CUDA kernel on a CUDA tensor (the sequential one under
    `cuda_build.mma_sync_only`), `s4d_scan_plain` on a CPU tensor."""
    if u.device.type == "cpu":
        return s4d_scan_plain(p, u)
    if u.device.type != "cuda":
        raise ValueError(f"s4d_scan: unsupported device {u.device}")
    n = _check_layer(p, u)
    route = "sequential" if cuda_build.FORCED_ROUTE else "chunked"
    y = _sequential(p, u) if route == "sequential" else _chunked(p, u, n)
    cuda_build.LAUNCHES["s4d_scan"] += 1
    cuda_build.LAUNCHES[f"s4d_scan:{route}"] += 1
    return y
