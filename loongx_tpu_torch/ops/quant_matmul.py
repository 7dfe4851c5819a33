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
CUDA kernels ``csrc/quant_matmul_t.cu``):

  * `quant_matmul_t` / `quant_matmul_t_stacked` -- dx[m, k] = sum_n
    cast(dy[m, n] * scale[n]) * Wq[k, n] with the weight in its stored
    [K, N] layout (block ``blk`` of a stack by pointer offset).

The forward and transposed kernels run on CUDA tensors and their plain
versions on CPU tensors; nothing falls back.
In W8A8 mode the GEMM is preceded by `act_quant`, a small kernel of the
same source that quantizes the activations (one warp per (row, group)
where `act_quant_route` says so: every FLUX shape), except on the K 64
route, whose kernel computes the same codes itself.  Hand-written forward
GEMMs share the contracts: the W8A8 GEMM on wgmma (TMA ring, the weight
read K-major, ``qmm_wgmma_kernel``) and the weight-only GEMM on bf16 wgmma
(TMA ring, the int8 weight widened in registers as the operand of y^T =
W^T x^T, ``qmm_bf16_wgmma_kernel``) take every shape their 128 x 128 tiles
cover, the split-K kernel (``qmm_splitk_kernel``: K split over a
thread-block cluster, `splitk_plan`) both modes at N below one tile (the
final proj_out, N 64), the K 64 kernel (``qmm_k64_kernel``: one 64-wide
k panel, W8A8 quantizing x in the kernel, no activation pass) both modes
at x_embedder, the ``mma.sync`` kernel (``qmm_kernel``) the rest;
`qmm_route` is the rule, a dispatch by shape.  The W8A8 GEMM on wgmma reads
its weight K-major: the first launch that routes a weight there makes it
K-major in place (`ops.w8a8_layout`: the same logical tensor, its strides
the marker), and a launch of any other kernel makes it ``[K, N]`` again,
once.  CPU tensors keep their layout: the plain versions read either.  The
transposed products
likewise: ``qmm_t_wgmma_kernel`` (bf16 wgmma with the weight widened in
registers, after a pre-scale pass over dy) and ``qmm_t_narrow_kernel``
(a contraction of at most 64, the pre-scale and the widening in the kernel:
the proj_out backward) where `qmm_t_route` says so, ``qmm_t_kernel`` on
``mma.sync`` the rest.  Each launch counts under its
entry's name and under ``"<name>:<route>"``.

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

The fused-elementwise forms of the stacked and fused-qkv contracts (the
TPU kernels' ``_ln_mod_prologue`` and ``_gate_res_epilogue``, reached in
the JAX package through LOONGX_FUSE_LN / LOONGX_FUSE_GATE):

  * ``ab`` [8, K] (rows a_main / b_main / a_cond / b_cond): the LN + adaLN
    prologue x' = ((bf16(x) - mean) * rstd) * a_seg + b_seg in float32,
    each operation rounded on its own, with the per-row (mean, rstd) of x
    computed ahead of the GEMM (`ln_row_stats`: a small kernel of the same
    source on CUDA, one warp a row where `ln_stats_route` says so; the JAX
    recipe in PyTorch on CPU).  W8A8 quantizes the float32 x' as it is
    (`act_quant` with ``ab``: the prologue runs in the activation pass);
    weight-only rounds x' to bf16: on the wgmma route in a pass of its own
    ahead of the GEMM (`ln_mod_pass`, which computes the stats itself on
    the warp route), on ``mma.sync`` on the A-tile load;
  * ``resid`` [M, N] + ``gate`` [8, N] (rows gate_main / gate_cond): the
    store becomes out = bf16(float(bf16(resid)) + g_seg * z), z the float32
    epilogue value (never rounded before the gate);
  * the segment of a row is ``row >= seg_boundary`` on global row ids.

With ``ab`` or ``resid`` the plain version is the kernel's arithmetic at
any input dtype (x taken as bf16, a bf16 output), as the JAX package's
fused path always runs its kernel.  Shapes the stacked tiling cannot cover
compose the prologue and epilogue around the unfused product instead, as
the JAX package does (LN and affine rounded to bf16 first).

The transposed product rounds dy * scale (fp32) to dy's dtype before the
contraction, as the TPU kernel rounds it to bf16, and sums in fp32; for
bf16 dy that is the CUDA kernel exactly, for float32 dy the JAX package's
XLA transpose of its dequant path.

Autograd (the JAX custom VJPs): `quant_matmul_vjp`,
`quant_matmul_stacked_vjp`, `quant_linear_gelu_stacked` and
`quant_linear_gelu` are differentiable in x only.  The frozen int8 weight,
scale and bias get no gradient, and no dx is computed when x needs none
(``ctx.needs_input_grad``).  The gelu variants recompute the pre-activation
in their backward, as the JAX package does.  With ``lora`` = (A, B, ms)
the first two add the QLoRA delta to the kernel's output as one rank-r
update (`lora_factor`, `lora_update`) and are differentiable in A and B
too: no [M, N] or [M, K] tensor is widened to float32 in either
direction (the small products sum in float32, `_mm`).
`quant_ln_mod_linear_stacked` and `quant_gate_res_linear_stacked` are the
fused forms' autograd Functions: dx through the transposed kernel, the LN,
affine and gate backward in PyTorch, real gradients for ``ab``, ``resid``
and ``gate`` (they chain to the adaLN projections), none for the int8
leaves.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from loongx_tpu_torch.ops import cuda_build, w8a8_layout

EPI_BIAS, EPI_GELU, EPI_QKV, EPI_GATE, EPI_GELU_GATE = 0, 1, 2, 3, 4
_LN_EPS = 1e-6  # the FLUX layer norm's epsilon, as the JAX package's _LN_EPS
_P, _I = ctypes.c_void_p, ctypes.c_int
_GEMM_SIGNATURE = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                   _I, _I, _I, _I, _I, _I, _I, _P]
_QUANT_SIGNATURE = [_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P]
_T_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _P]
_STATS_SIGNATURE = [_P, _I, _I, _I, _P, _I, _P]
_PASS_SIGNATURE = [_P, _I, _I, _P, _I, _P, _I, _P, _P]
_WGMMA_SIGNATURE = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                    _I, _I, _I, _I, _I, _P]
_BF16_WGMMA_SIGNATURE = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _P]
_T_WGMMA_SIGNATURE = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_SPLITK_SIGNATURE = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _P]
_K64_SIGNATURE = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                  _P]


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


def stacked_ok(k: int, n: int) -> bool:
    """Can the stacked TPU tiling cover [K, N] (_stacked_ok)?"""
    block_n, block_k = _stacked_blocks(k, n)
    return k % min(block_k, k) == 0 and n % min(block_n, n) == 0


def stacked_w8a8_group(k: int, n: int) -> Tuple[int, int]:
    """(group, padded K) of the stacked W8A8 kernel: its k tile (3072 at
    every FLUX shape, K = 12288 included); shapes the stacked tiling cannot
    cover take the flat kernel's policy, as the TPU path falls back."""
    if stacked_ok(k, n):
        return min(_stacked_blocks(k, n)[1], k), k
    return flat_w8a8_group(k, n)


WGMMA_TILE = 128  # the wgmma GEMMs' M and N tile and their k stage

# The split-K GEMM (N below one tile): a cluster of blocks shares one tile of
# rows, each block one slice of K
SPLITK_CLUSTER = 8  # blocks a cluster: the portable maximum
SPLITK_ROWS = 64  # rows of x a block: one m64 wgmma
SPLITK_MAX_PANELS = 16  # 128-byte-wide k panels a slice, one mbarrier each
SMEM_PER_BLOCK = 232448  # the dynamic shared memory a block may take (227 KB)


@dataclass(frozen=True)
class SplitKPlan:
    """How the split-K kernel cuts a [K, N] weight: ``cluster`` blocks
    share ``rows`` rows of x, block r taking k (W8A8: code bytes of k_pad)
    [r slice_k, (r + 1) slice_k) in panels of ``panel_k`` (128 bytes: 64
    bf16 or 128 codes); ``smem`` is the shared memory a block takes."""
    cluster: int
    slice_k: int
    rows: int
    panel_k: int
    smem: int


def splitk_smem(slice_k: int, n: int, w8a8: bool) -> int:
    """Bytes of shared memory a split-K block takes (``sk::smem_bytes`` in
    csrc/quant_matmul.cu): its x panels and, W8A8, a ring of two K-major
    weight panels (N padded to a 64 or 128 tile; the partial tile goes over
    them after the products), the raw weight slice, the buffer that
    receives its rows of every block's partial tile, one mbarrier a panel
    and one for that buffer, the slack that aligns the base to 1024
    bytes."""
    nt = 64 if n <= 64 else 128
    panels = slice_k // (128 if w8a8 else 64)
    tiles = (panels * SPLITK_ROWS * 128
             + (min(panels, 2) * nt * 128 if w8a8 else 0))
    red = SPLITK_ROWS * (nt + 8) * 4
    recv = SPLITK_ROWS * (nt + 4) * 4
    return (1024 + _round_up(max(tiles, red), 1024)
            + _round_up(slice_k * n, 1024) + _round_up(recv, 1024)
            + 8 * (panels + 1))


def splitk_plan(k: int, n: int, group: int, k_pad: int,
                w8a8: bool) -> Optional[SplitKPlan]:
    """The split-K kernel's cut of a [K, N] weight, or None where it cannot
    take the shape: N 16..112, a multiple of 16; K a multiple of 128 and
    the contraction (W8A8: k_pad) whole `SPLITK_CLUSTER` slices of whole
    128-byte panels; in W8A8 no slice straddles an activation group (each
    group's s32 partials then sum exactly, as the mma.sync kernel's do);
    the slice's panels fit a block's shared memory."""
    if n % 16 or not 16 <= n < WGMMA_TILE or k % WGMMA_TILE:
        return None
    kloop, panel = (k_pad, 128) if w8a8 else (k, 64)
    cluster = SPLITK_CLUSTER
    if kloop % (cluster * panel):
        return None
    slice_k = kloop // cluster
    if w8a8 and group % slice_k:
        return None
    smem = splitk_smem(slice_k, n, w8a8)
    if slice_k // panel > SPLITK_MAX_PANELS or smem > SMEM_PER_BLOCK:
        return None
    return SplitKPlan(cluster, slice_k, SPLITK_ROWS, panel, smem)


K64_MAX = 64  # the K 64 kernel's contraction: one 64-wide panel


def qmm_route(k: int, n: int, group: int, k_pad: int, w8a8: bool,
              prologue: bool = False) -> str:
    """The forward GEMM that takes a [K, N] weight, a rule on shapes:
    ``"wgmma"`` where K and N are at least one 128 tile and the 128-deep k
    stages are whole (W8A8: k_pad and the activation group multiples of
    128; weight-only: K a multiple of 128), at every M (the M 1-2
    modulation matvecs included: the wgmma kernels are faster there too);
    ``"splitk"`` where N is below one tile and `splitk_plan` can cut K
    (the final proj_out, K 3072 N 64); ``"k64"`` (``qmm_k64_kernel``) where
    K is 16..64, a multiple of 16, and N whole 128 tiles, in W8A8 with one
    activation group over the padded row (group == k_pad), which the
    kernel quantizes itself (x_embedder, K 64); ``"mma_sync"`` for the
    rest.  The LN + adaLN prologue form (``prologue``) takes the same rule
    except that W8A8 leaves ``"k64"`` for ``"mma_sync"``: W8A8 runs the
    prologue in its activation pass, weight-only on the wgmma, split-K
    and K 64 routes in `ln_mod_pass` ahead of the GEMM."""
    t = WGMMA_TILE
    if splitk_plan(k, n, group, k_pad, w8a8) is not None:
        return "splitk"
    if (16 <= k <= K64_MAX and k % 16 == 0 and n >= t and n % t == 0
            and not (w8a8 and (prologue or group != k_pad))):
        return "k64"
    if k < t or n < t:
        return "mma_sync"
    if w8a8:
        return "wgmma" if group % t == 0 and k_pad % t == 0 else "mma_sync"
    return "wgmma" if k % t == 0 else "mma_sync"


QMM_T_NARROW_MAX_N = 64  # the narrow kernel's contraction: one 128-byte bf16 panel


def qmm_t_route(k: int, n: int) -> str:
    """The transposed GEMM that takes a [K, N] weight (dy [M, N] -> dx
    [M, K]), a rule on shapes, at every M, K whole 128 tiles (its 128
    weight rows a tile): ``"wgmma"`` where N is whole 128-deep stages;
    ``"narrow"`` (``qmm_t_narrow_kernel``, the pre-scale in the kernel)
    where N is 16..64, a multiple of 16 (the proj_out backward, N 64);
    ``"mma_sync"`` for the rest."""
    t = WGMMA_TILE
    if k % t or k < t:
        return "mma_sync"
    if n % t == 0 and n >= t:
        return "wgmma"
    if n % 16 == 0 and 16 <= n <= QMM_T_NARROW_MAX_N:
        return "narrow"
    return "mma_sync"


# the warp kernel keeps a whole group in its lanes' registers
ACT_QUANT_MAX_GROUP = 3072


def act_quant_route(k: int, group: int) -> str:
    """The W8A8 activation pass's kernel, a rule on shapes: ``"warp"`` (one
    warp per (row, group), 16-byte loads and a group in registers) where K
    and the group are multiples of 8 and the group is at most 3072 (every
    FLUX shape); ``"block"`` (one block per (row, group)) for the rest."""
    ok = k % 8 == 0 and group % 8 == 0 and group <= ACT_QUANT_MAX_GROUP
    return "warp" if ok else "block"


def active_act_quant_route(k: int, group: int) -> str:
    """The activation pass's kernel now: the block-per-group one under
    `cuda_build.mma_sync_only`, else `act_quant_route`."""
    return "block" if cuda_build.FORCED_ROUTE else act_quant_route(k, group)


# the warp row kernels keep a whole row in their lanes' registers
LN_ROW_MAX = 3072


def ln_stats_route(k: int, dtype: torch.dtype) -> str:
    """The row stats' kernel, a rule on the row: ``"warp"`` (one warp a
    row, 16-byte loads and the row in registers) for bf16 x whose K is a
    multiple of 8 and at most 3072 (every FLUX fused site); ``"block"``
    (one block a row) for the rest, float32 x included.  `ln_mod_pass`
    takes the same rule: on ``"warp"`` it computes the stats itself, else
    it applies `ln_row_stats`'s."""
    ok = dtype == torch.bfloat16 and k % 8 == 0 and k <= LN_ROW_MAX
    return "warp" if ok else "block"


def active_ln_stats_route(k: int, dtype: torch.dtype) -> str:
    """The row stats' kernel now: the block-per-row one under
    `cuda_build.mma_sync_only`, else `ln_stats_route`."""
    return "block" if cuda_build.FORCED_ROUTE else ln_stats_route(k, dtype)


def active_route(rule: str) -> str:
    """The route a launch takes now: the forced route of
    `cuda_build.mma_sync_only` if any, else ``rule`` (`qmm_route`'s or
    `qmm_t_route`'s)."""
    return cuda_build.FORCED_ROUTE or rule


def launch_route(k: int, n: int, group: int, k_pad: int, w8a8: bool,
                 prologue: bool = False) -> str:
    """The forward GEMM a launch takes now: `active_route` of `qmm_route`,
    except that a W8A8 weight whose K is not a multiple of 16 (none in
    FLUX or HiDream) leaves ``"wgmma"`` for ``"mma_sync"``: the K-major
    weight's rows lie K bytes apart, and TMA takes strides of whole 16
    bytes."""
    route = active_route(qmm_route(k, n, group, k_pad, w8a8, prologue))
    if w8a8 and route == "wgmma" and k % 16:
        return "mma_sync"
    return route


def weight_layout(w: torch.Tensor, kdim: int, route: str, w8a8: bool) -> bool:
    """Put int8 weight ``w`` (contraction axis ``kdim``) in the layout the
    forward ``route`` reads, in place (`ops.w8a8_layout`): K-major for the
    W8A8 GEMM on wgmma, ``[K, N]`` for every other kernel; True where it
    is in that layout afterwards (a view of part of a stack cannot
    move)."""
    if w8a8 and route == "wgmma":
        return w8a8_layout.to_kmajor(w, kdim)
    return w8a8_layout.to_kn(w, kdim)


def qkv_supported(k: int, n3: int, head_dim: int) -> bool:
    """Can the fused-qkv kernel take this shape (quant_qkv_stacked)?"""
    h = n3 // 3
    block_k = min(_stacked_blocks(k, n3)[1], k)
    return n3 % 3 == 0 and h % head_dim == 0 and k % block_k == 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def ln_row_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """[M, K] -> float32 [M, 2]: each row's (mean, rstd) in the JAX
    package's recipe (_ln_mean_rstd): mean, then mean((x - mean)^2), then
    rsqrt(var + _LN_EPS)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    return torch.cat([mean, torch.rsqrt(var + _LN_EPS)], -1)


def _seg_rows(m: int, boundary: int, device) -> torch.Tensor:
    """[M, 1] bool: does the row belong to the cond segment?"""
    return (torch.arange(m, device=device) >= boundary)[:, None]


def _seg_select(main: torch.Tensor, cond: torch.Tensor, m: int,
                boundary: int) -> torch.Tensor:
    return torch.where(_seg_rows(m, boundary, main.device), cond, main)


def _ln_affine(xf: torch.Tensor, ab: torch.Tensor, stats: torch.Tensor,
               boundary: int) -> torch.Tensor:
    """((xf - mean) * rstd) * a_seg + b_seg on float32 xf, each operation
    rounded on its own (the kernel's order)."""
    m = xf.shape[0]
    xn = (xf - stats[:, 0:1]) * stats[:, 1:2]
    return (xn * _seg_select(ab[0], ab[2], m, boundary)
            + _seg_select(ab[1], ab[3], m, boundary))


def ln_mod_plain(x: torch.Tensor, ab: torch.Tensor, stats: torch.Tensor,
                 boundary: int) -> torch.Tensor:
    """The LN + adaLN prologue in float32 on the kernel's bf16 x."""
    return _ln_affine(x.to(torch.bfloat16).float(), ab, stats, boundary)


def ln_mod_pass_plain(x: torch.Tensor, ab: torch.Tensor,
                      boundary: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the weight-only prologue pass: (bf16 x' =
    bf16(`ln_mod_plain` of x's `ln_row_stats_plain`), those stats)."""
    stats = ln_row_stats_plain(x)
    return ln_mod_plain(x, ab, stats, boundary).to(torch.bfloat16), stats


def gate_res_plain(z: torch.Tensor, resid: torch.Tensor, gate: torch.Tensor,
                   boundary: int) -> torch.Tensor:
    """The gate + residual epilogue on the float32 z: float(bf16(resid)) +
    g_seg * z in float32."""
    g = _seg_select(gate[0], gate[1], z.shape[0], boundary)
    return resid.to(torch.bfloat16).float() + g * z


def _quant_groups(xf: torch.Tensor, group: int,
                  k_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (row, group) int8 quantization of float32 values xf [M, K]."""
    xf = F.pad(xf, (0, k_pad - xf.shape[1]))
    xg = xf.view(xf.shape[0], k_pad // group, group)
    absmax = xg.abs().amax(-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the true quotient in the last bit
    xs = torch.where(absmax == 0, torch.ones_like(absmax),
                     absmax / absmax.new_full((), 127.0))
    q = torch.clamp(torch.round(xg / xs[..., None]), -127, 127)
    return q.view(xf.shape[0], k_pad), xs


def act_quant_plain(x: torch.Tensor, group: int, k_pad: int,
                    ab: Optional[torch.Tensor] = None, seg_boundary: int = 0,
                    stats: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16(x) [M, K] -> (q float32 [M, k_pad] integer-valued, x_scale
    float32 [M, k_pad // group]); with ``ab`` the float32 prologue output
    is quantized instead (not rounded to bf16 first), from ``stats`` or,
    when not given, x's `ln_row_stats_plain`."""
    if ab is not None:
        if stats is None:
            stats = ln_row_stats_plain(x)
        return _quant_groups(ln_mod_plain(x, ab, stats, seg_boundary), group,
                             k_pad)
    return _quant_groups(x.to(torch.bfloat16).float(), group, k_pad)


def _plain_acc(x, w_q, scale, bias, w8a8: bool, group: int, k_pad: int,
               ab=None, seg_boundary: int = 0):
    """(z = acc * scale + bias in float32, output dtype) of the plain MAC:
    per-group s8 products (integer-valued float32 matmuls) rescaled into
    the accumulator for W8A8, x @ w in float32 for weight-only.  With
    ``ab`` the MAC takes the prologue's output (weight-only: rounded to
    bf16, the kernel's A tile)."""
    if ab is not None and not w8a8:
        x = ln_mod_pass_plain(x, ab, seg_boundary)[0]
    if w8a8:
        xq, xs = act_quant_plain(x, group, k_pad, ab, seg_boundary)
        wf = F.pad(w_q.float(), (0, 0, 0, k_pad - w_q.shape[0]))
        acc = torch.zeros(x.shape[0], w_q.shape[1], dtype=torch.float32,
                          device=x.device)
        for gi in range(k_pad // group):
            part = slice(gi * group, (gi + 1) * group)
            acc = acc + torch.matmul(xq[:, part], wf[part]) * xs[:, gi:gi + 1]
        out_dtype = torch.bfloat16
    else:
        # row-major float32 weight: the same sums from either int8 layout
        acc = torch.matmul(x.float(), w_q.float().contiguous())
        out_dtype = x.dtype
    z = acc * scale.reshape(-1).float()
    if bias is not None:
        z = z + bias.reshape(-1).float()
    return z, out_dtype


def qmm_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              activation: Optional[str] = None, w8a8: bool = False,
              group: int = 0, k_pad: int = 0,
              ab: Optional[torch.Tensor] = None,
              resid: Optional[torch.Tensor] = None,
              gate: Optional[torch.Tensor] = None,
              seg_boundary: int = 0) -> torch.Tensor:
    """Plain version of the kernel on a [K, N] weight (a view of a stack is
    fine): x [M, K]; scale/bias broadcastable to [N]; ``ab`` / ``resid`` +
    ``gate`` the fused prologue / epilogue (x taken as bf16 then, as the
    kernel does; the output is bf16)."""
    if resid is not None and ab is None:
        x = x.to(torch.bfloat16)
    z, out_dtype = _plain_acc(x, w_q, scale, bias, w8a8, group, k_pad, ab,
                              seg_boundary)
    if activation == "gelu_tanh":
        z = F.gelu(z, approximate="tanh")
    elif activation is not None:
        raise ValueError(f"unknown fused activation {activation!r}")
    if resid is not None:
        z = gate_res_plain(z, resid, gate, seg_boundary)
    return z.to(out_dtype)


def rms_heads_plain(z: torch.Tensor, head_dim: int,
                    weight: torch.Tensor) -> torch.Tensor:
    """Per-head RMS (eps 1e-6) of float32 z [M, H] times weight [H]."""
    zg = z.unflatten(-1, (-1, head_dim))
    zg = zg * torch.rsqrt(zg.square().mean(-1, keepdim=True) + 1e-6)
    return zg.flatten(-2) * weight.float()


def quant_qkv_plain(x, w_q, scale, bias, norm_w, head_dim: int,
                    w8a8: bool = False, group: int = 0, k_pad: int = 0,
                    ab: Optional[torch.Tensor] = None, seg_boundary: int = 0):
    """Plain version of the fused-qkv kernel on a [K, 3H] weight: the RMS
    epilogue runs on the float32 z, before the one cast."""
    z, out_dtype = _plain_acc(x, w_q, scale, bias, w8a8, group, k_pad, ab,
                              seg_boundary)
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
    return torch.matmul(a, w_q.float().contiguous().t()).to(dy.dtype)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def ln_row_stats(x: torch.Tensor) -> torch.Tensor:
    """Each row's (mean, rstd) of x [M, K] as float32 [M, 2]: launches the
    kernel of `ln_stats_route` on a CUDA tensor (bf16 or float32 as given;
    other dtypes as float32; the block-per-row kernel under
    `cuda_build.mma_sync_only`), `ln_row_stats_plain` on CPU.  Each launch
    counts as ``qmm_ln_stats`` and ``qmm_ln_stats:<route>``."""
    if x.device.type == "cpu":
        return ln_row_stats_plain(x)
    _check(x.ndim == 2 and x.is_floating_point(),
           f"x must be a floating-point [M, K] matrix, got {x.dtype} "
           f"{tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        x = x.float()
    x = x.contiguous()
    m, k = x.shape
    route = active_ln_stats_route(k, x.dtype)
    if route == "warp" and x.data_ptr() % 16:
        x = x.clone()  # the warp kernel loads x in 16-byte chunks
    stats = torch.empty(m, 2, dtype=torch.float32, device=x.device)
    fn = cuda_build.entry("quant_matmul", "qmm_ln_stats", _STATS_SIGNATURE)
    cuda_build.check(fn(x.data_ptr(), int(x.dtype == torch.float32), m, k,
                        stats.data_ptr(), int(route == "warp"),
                        torch.cuda.current_stream(x.device).cuda_stream),
                     f"qmm_ln_stats ({route})")
    cuda_build.LAUNCHES["qmm_ln_stats"] += 1
    cuda_build.LAUNCHES[f"qmm_ln_stats:{route}"] += 1
    return stats


def ln_mod_pass(x: torch.Tensor, ab: torch.Tensor,
                seg_boundary: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight-only LN + adaLN prologue as a pass ahead of the GEMM:
    x [M, K] -> (x' = bf16(ln_mod(x)) [M, K], the float32 row stats [M, 2]
    it used).  On a CUDA tensor one launch, of ``ln_mod_pass_kernel``
    (the stats computed in its registers) where `ln_stats_route` says
    ``"warp"``, else of ``ln_mod_apply_kernel`` on `ln_row_stats`'s; each
    counts as ``qmm_ln_mod_pass`` and ``qmm_ln_mod_pass:<route>``.
    `ln_mod_pass_plain` on CPU."""
    if x.device.type == "cpu":
        return ln_mod_pass_plain(x, ab, seg_boundary)
    _check(x.ndim == 2, f"x must be [M, K], got {tuple(x.shape)}")
    m, k = x.shape
    xb = _cuda_x(x, k)
    _check(k % 8 == 0, f"prologue pass: K {k} not a multiple of 8")
    _cuda_vec(ab, (8, k), "ab", xb.device)
    if ab.data_ptr() % 16:
        ab = ab.clone()  # the kernels load ab in 16-byte chunks
    route = active_ln_stats_route(k, x.dtype)
    stats = (ln_row_stats(x) if route == "block" else
             torch.empty(m, 2, dtype=torch.float32, device=xb.device))
    out = torch.empty(m, k, dtype=torch.bfloat16, device=xb.device)
    fn = cuda_build.entry("quant_matmul", "qmm_ln_mod_pass", _PASS_SIGNATURE)
    cuda_build.check(fn(xb.data_ptr(), m, k, stats.data_ptr(),
                        int(route == "block"), ab.data_ptr(), seg_boundary,
                        out.data_ptr(),
                        torch.cuda.current_stream(xb.device).cuda_stream),
                     f"qmm_ln_mod_pass ({route})")
    cuda_build.LAUNCHES["qmm_ln_mod_pass"] += 1
    cuda_build.LAUNCHES[f"qmm_ln_mod_pass:{route}"] += 1
    return out, stats


def act_quant(x: torch.Tensor, group: int, k_pad: int,
              ab: Optional[torch.Tensor] = None, seg_boundary: int = 0,
              stats: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The W8A8 activation pass: bf16(x) [M, K] -> (int8 [M, k_pad], float32
    x_scale [M, k_pad // group]), K zero-padded to k_pad.  With ``ab`` [8,
    K] the pass quantizes the LN + adaLN prologue's float32 output instead
    (``stats``: x's `ln_row_stats`, computed here when not given).
    Launches the kernel of `act_quant_route` on a CUDA tensor (the
    block-per-group one under `cuda_build.mma_sync_only`); `act_quant_plain`
    on CPU.  Each launch counts as ``qmm_act_quant`` (``qmm_act_quant_ln``
    with ``ab``) and as ``<name>:<route>``."""
    if x.device.type == "cpu":
        q, xs = act_quant_plain(x, group, k_pad, ab, seg_boundary, stats)
        return q.to(torch.int8), xs
    m, k = x.shape
    if ab is not None and stats is None:
        stats = ln_row_stats(x)
    x = _cuda_x(x, k)
    _check(group % 64 == 0 and k_pad % group == 0 and k <= k_pad,
           f"W8A8 kernel: group {group} must be a multiple of 64 dividing "
           f"k_pad {k_pad} >= K {k}")
    _cuda_vec(ab, (8, k), "ab", x.device)
    _cuda_vec(stats, (m, 2), "LN row stats", x.device)
    if ab is not None and ab.data_ptr() % 16:
        ab = ab.clone()  # the warp kernel loads ab in 16-byte chunks
    route = active_act_quant_route(k, group)
    a = torch.empty(m, k_pad, dtype=torch.int8, device=x.device)
    xs = torch.empty(m, k_pad // group, dtype=torch.float32, device=x.device)
    fn = cuda_build.entry("quant_matmul", "qmm_act_quant", _QUANT_SIGNATURE)
    name = "qmm_act_quant" if ab is None else "qmm_act_quant_ln"
    cuda_build.check(fn(x.data_ptr(), m, k, group, k_pad // group, a.data_ptr(),
                        xs.data_ptr(), _ptr(stats), _ptr(ab), seg_boundary,
                        int(route == "warp"),
                        torch.cuda.current_stream(x.device).cuda_stream),
                     f"{name} ({route})")
    cuda_build.LAUNCHES[name] += 1
    cuda_build.LAUNCHES[f"{name}:{route}"] += 1
    return a, xs


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _prologue(x, ab, seg_boundary: int, route: str, w8a8: bool):
    """(x, ab, stats) for `_launch` of a prologue form: the weight-only
    wgmma, split-K and K 64 routes run the prologue as its own pass (x becomes
    x', no ``ab`` left); the W8A8 activation pass and the weight-only
    ``mma.sync`` kernel apply ``ab`` with the row stats of the caller's
    x."""
    if ab is None:
        return x, None, None
    if route != "mma_sync" and not w8a8:
        return ln_mod_pass(x, ab, seg_boundary)[0], None, None
    return x, ab, ln_row_stats(x)


def _launch(name: str, x, route: str, w_ptr: int, k: int, n: int,
            scale_ptr: int, bias_ptr: Optional[int], epilogue: int,
            w8a8: bool, group: int, k_pad: int, out: torch.Tensor,
            norm_w_ptr: Optional[int] = None, head_dim: int = 0,
            plane_h: int = 0, ab=None, stats=None, resid=None, gate=None,
            seg_boundary: int = 0) -> None:
    """One GEMM launch on ``route`` (after the W8A8 activation pass, which
    takes the prologue in that mode, except on ``"k64"``, whose kernel
    quantizes x itself); ``x`` is the bf16 operand, ``stats`` the
    prologue's row stats of the caller's x."""
    m = x.shape[0]
    lib = cuda_build.library("quant_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xs = None
    if w8a8 and route != "k64":  # the K 64 kernel quantizes x itself
        a, xs = act_quant(x, group, k_pad, ab, seg_boundary, stats)
        ab = stats = None
    else:
        _check(k % 8 == 0, f"weight-only kernel: K {k} not a multiple of 8")
        a = x
    n_groups = k_pad // group if w8a8 else 0
    if route == "wgmma" and not w8a8:
        fn = lib.qmm_gemm_bf16_wgmma
        fn.argtypes, fn.restype = _BF16_WGMMA_SIGNATURE, ctypes.c_int
        code = fn(epilogue, a.data_ptr(), w_ptr, scale_ptr, bias_ptr,
                  norm_w_ptr, _ptr(resid), _ptr(gate), out.data_ptr(), m, k, n,
                  head_dim, plane_h, seg_boundary, 1, stream)
    elif route == "wgmma":
        fn = lib.qmm_gemm_wgmma
        fn.argtypes, fn.restype = _WGMMA_SIGNATURE, ctypes.c_int
        code = fn(epilogue, a.data_ptr(), _ptr(xs), w_ptr, scale_ptr, bias_ptr,
                  norm_w_ptr, _ptr(resid), _ptr(gate), out.data_ptr(), m, k,
                  k_pad, n, group, n_groups, head_dim, plane_h, seg_boundary,
                  stream)
    elif route == "k64":
        _check(ab is None, "the K 64 kernel takes no W8A8 prologue")
        fn = cuda_build.entry("quant_matmul", "qmm_gemm_k64", _K64_SIGNATURE)
        code = fn(int(w8a8), epilogue, x.data_ptr(), w_ptr, scale_ptr, bias_ptr,
                  norm_w_ptr, _ptr(resid), _ptr(gate), out.data_ptr(), m, k, n,
                  head_dim, plane_h, seg_boundary, stream)
    elif route == "splitk":
        plan = splitk_plan(k, n, group, k_pad, w8a8)
        fn = cuda_build.entry("quant_matmul", "qmm_gemm_splitk",
                              _SPLITK_SIGNATURE)
        code = fn(int(w8a8), epilogue, a.data_ptr(), _ptr(xs), w_ptr,
                  scale_ptr, bias_ptr, _ptr(resid), _ptr(gate), out.data_ptr(),
                  m, k, k_pad, n, group, n_groups, seg_boundary, plan.cluster,
                  plan.slice_k, plan.rows, stream)
    else:
        fn = lib.qmm_gemm
        fn.argtypes, fn.restype = _GEMM_SIGNATURE, ctypes.c_int
        code = fn(int(w8a8), epilogue, a.data_ptr(), _ptr(xs), w_ptr,
                  scale_ptr, bias_ptr, norm_w_ptr, _ptr(ab), _ptr(stats),
                  _ptr(resid), _ptr(gate), out.data_ptr(), m, k, k_pad, n,
                  group, n_groups, head_dim, plane_h, seg_boundary, stream)
    cuda_build.check(code, f"qmm_gemm ({name}, {route})")
    cuda_build.LAUNCHES[name] += 1
    cuda_build.LAUNCHES[f"{name}:{route}"] += 1


def _cuda_x(x: torch.Tensor, k: int) -> torch.Tensor:
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(x.ndim == 2 and x.shape[1] == k,
           f"x must be [M, {k}], got {tuple(x.shape)}")
    _check(x.is_floating_point(), f"x must be floating point, got {x.dtype}")
    x = x.to(torch.bfloat16).contiguous()
    # the kernels load x in 16-byte chunks
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _cuda_vec(t: Optional[torch.Tensor], shape, what: str, device):
    if t is None:
        return None
    _check(t.dtype == torch.float32 and t.is_contiguous() and t.device == device
           and tuple(t.shape) == tuple(shape),
           f"{what} must be contiguous float32 {tuple(shape)} on {device}, got "
           f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t


def _cuda_weight(w: torch.Tensor, device, in_layout: bool = True):
    """Check the weight a kernel reads; ``in_layout``: `weight_layout`'s
    answer (the route's layout, which a view of part of a stack cannot
    take)."""
    _check(w.dtype == torch.int8 and w.device == device,
           f"weight must be int8 on {device}, got {w.dtype} on {w.device}")
    _check(in_layout, f"weight {tuple(w.shape)} (strides {w.stride()}) is "
           "not in the layout its kernel reads (contiguous [K, N], or K-major "
           "for the W8A8 GEMM on wgmma) and cannot change in place: pass the "
           "whole stack or a tensor of its own")
    _check(w.shape[-1] % 16 == 0, f"N {w.shape[-1]} not a multiple of 16")


def _cuda_resid(resid: torch.Tensor, m: int, n: int, device) -> torch.Tensor:
    _check(resid.device == device and resid.is_floating_point()
           and tuple(resid.shape) == (m, n),
           f"resid must be floating point [{m}, {n}] on {device}, got "
           f"{resid.dtype} {tuple(resid.shape)} on {resid.device}")
    return resid.to(torch.bfloat16).contiguous()


def _check_fused(k: int, n: int, ab, resid, gate) -> None:
    if (resid is None) != (gate is None):
        raise ValueError("resid and gate come together (the gate epilogue)")
    if ab is not None and tuple(ab.shape) != (8, k):
        raise ValueError(f"ab must be [8, {k}], got {tuple(ab.shape)}")
    if ab is not None and ab.device.type == "cuda":
        _check(ab.data_ptr() % 16 == 0, "ab must be 16-byte aligned (the "
               "weight-only prologue loads it in float4s)")
    if gate is not None and tuple(gate.shape) != (8, n):
        raise ValueError(f"gate must be [8, {n}], got {tuple(gate.shape)}")


def _xla_ln_mod(x, ab, boundary: int) -> torch.Tensor:
    """The JAX package's composition of the prologue where the stacked
    tiling cannot take it (_xla_ln_mod): LN of x as given, the affine, one
    bf16 rounding."""
    return _ln_affine(x.float(), ab, ln_row_stats(x),
                      boundary).to(torch.bfloat16)


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None,
                 w8a8: bool = False) -> torch.Tensor:
    """x [M, K] @ w_q [K, N] int8 * scale [1, N] (+ bias [1, N]) (+ gelu)."""
    k, n = w_q.shape
    group, k_pad = flat_w8a8_group(k, n)
    route = launch_route(k, n, group, k_pad, w8a8)
    in_layout = weight_layout(w_q, 0, route, w8a8)
    if x.device.type == "cpu":
        return qmm_plain(x, w_q, scale, bias, activation, w8a8, group, k_pad)
    x = _cuda_x(x, k)
    _cuda_weight(w_q, x.device, in_layout)
    _cuda_vec(scale, (1, n), "scale", x.device)
    _cuda_vec(bias, (1, n), "bias", x.device)
    out = torch.empty(x.shape[0], n, dtype=torch.bfloat16, device=x.device)
    _launch("qmm_flat", x, route, w_q.data_ptr(), k, n, scale.data_ptr(),
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
                         w8a8: bool = False,
                         ab: Optional[torch.Tensor] = None,
                         resid: Optional[torch.Tensor] = None,
                         gate: Optional[torch.Tensor] = None,
                         seg_boundary: int = 0) -> torch.Tensor:
    """x [M, K] @ w_q3[blk] ([NB, K, N] int8) * scale3[blk] ([NB, 1, N])
    (+ bias3[blk]) (+ gelu); ``ab`` [8, K] fuses the LN + adaLN prologue,
    ``resid`` [M, N] + ``gate`` [8, N] the gate + residual epilogue, rows
    split into segments at ``seg_boundary``."""
    nb, k, n = w_q3.shape
    if not 0 <= blk < nb:
        raise IndexError(f"block {blk} out of range for a stack of {nb}")
    _check_fused(k, n, ab, resid, gate)
    group, k_pad = stacked_w8a8_group(k, n)
    if (ab is not None or resid is not None) and not stacked_ok(k, n):
        # the JAX package's route where the stacked tiling cannot cover the
        # shape: the prologue and epilogue composed around the product
        if ab is not None:
            x = _xla_ln_mod(x, ab, seg_boundary)
        y = quant_matmul_stacked(x.to(torch.bfloat16), w_q3, scale3, blk,
                                 bias3=bias3, activation=activation, w8a8=w8a8)
        if resid is not None:
            y = gate_res_plain(y.float(), resid, gate,
                               seg_boundary).to(torch.bfloat16)
        return y
    route = launch_route(k, n, group, k_pad, w8a8, ab is not None)
    in_layout = weight_layout(w_q3, 1, route, w8a8)
    if x.device.type == "cpu":
        return qmm_plain(x, w_q3[blk], scale3[blk],
                         None if bias3 is None else bias3[blk], activation,
                         w8a8, group, k_pad, ab, resid, gate, seg_boundary)
    m = x.shape[0]
    name = ("qmm_stacked" + ("_ln" if ab is not None else "")
            + ("_gate" if resid is not None else ""))
    x, ab, stats = _prologue(x, ab, seg_boundary, route, w8a8)
    x = _cuda_x(x, k)
    _cuda_weight(w_q3, x.device, in_layout)
    _cuda_vec(scale3, (nb, 1, n), "scale", x.device)
    _cuda_vec(bias3, (nb, 1, n), "bias", x.device)
    _cuda_vec(ab, (8, k), "ab", x.device)
    _cuda_vec(gate, (8, n), "gate", x.device)
    if resid is not None:
        resid = _cuda_resid(resid, m, n, x.device)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    gelu = activation == "gelu_tanh"
    if resid is not None:
        epilogue = EPI_GELU_GATE if gelu else EPI_GATE
    else:
        epilogue = EPI_GELU if gelu else EPI_BIAS
    _launch(name, x, route, _stack_ptr(w_q3, blk), k, n,
            _stack_ptr(scale3, blk),
            None if bias3 is None else _stack_ptr(bias3, blk), epilogue, w8a8,
            group, k_pad, out, ab=ab, stats=stats, resid=resid, gate=gate,
            seg_boundary=seg_boundary)
    return out


def quant_qkv_stacked(x: torch.Tensor, w_q3: torch.Tensor,
                      scale3: torch.Tensor, bias3: torch.Tensor,
                      norm_w: torch.Tensor, blk: int, head_dim: int, *,
                      w8a8: bool = False, ab: Optional[torch.Tensor] = None,
                      seg_boundary: int = 0):
    """(q, k, v), each [M, H]: one matmul over the fused [NB, K, 3H] weight,
    per-head RMS (eps 1e-6) times norm_w[0] / norm_w[1] on q / k, v as is.
    norm_w: [3, H] float32; ``ab`` [8, K] fuses the LN + adaLN prologue."""
    nb, k, n3 = w_q3.shape
    if not 0 <= blk < nb:
        raise IndexError(f"block {blk} out of range for a stack of {nb}")
    _check_fused(k, n3, ab, None, None)
    h = n3 // 3
    if not qkv_supported(k, n3, head_dim):
        # the TPU path's fallback: (the prologue composed ahead,) the plain
        # matmul kernel, then split + RMS
        if ab is not None:
            x = _xla_ln_mod(x, ab, seg_boundary)
        y = quant_matmul_stacked(x, w_q3, scale3, blk, bias3=bias3,
                                 w8a8=w8a8).float()
        q, kk, v = y.chunk(3, dim=-1)
        return (rms_heads_plain(q, head_dim, norm_w[0]).to(torch.bfloat16),
                rms_heads_plain(kk, head_dim, norm_w[1]).to(torch.bfloat16),
                v.to(torch.bfloat16))
    group, k_pad = stacked_w8a8_group(k, n3)
    route = launch_route(k, n3, group, k_pad, w8a8, ab is not None)
    in_layout = weight_layout(w_q3, 1, route, w8a8)
    if x.device.type == "cpu":
        return quant_qkv_plain(x, w_q3[blk], scale3[blk], bias3[blk], norm_w,
                               head_dim, w8a8, group, k_pad, ab, seg_boundary)
    name = "qmm_qkv_stacked" + ("_ln" if ab is not None else "")
    x, ab, stats = _prologue(x, ab, seg_boundary, route, w8a8)
    x = _cuda_x(x, k)
    _cuda_weight(w_q3, x.device, in_layout)
    _cuda_vec(scale3, (nb, 1, n3), "scale", x.device)
    _cuda_vec(bias3, (nb, 1, n3), "bias", x.device)
    _cuda_vec(norm_w, (3, h), "norm_w", x.device)
    _cuda_vec(ab, (8, k), "ab", x.device)
    _check(h % 128 == 0, f"qkv kernel: H {h} not a multiple of 128")
    _check(head_dim in (32, 64, 128), f"qkv kernel: head_dim {head_dim}")
    out = torch.empty(3, x.shape[0], h, dtype=torch.bfloat16, device=x.device)
    _launch(name, x, route, _stack_ptr(w_q3, blk), k, n3,
            _stack_ptr(scale3, blk), _stack_ptr(bias3, blk), EPI_QKV, w8a8,
            group, k_pad, out,
            norm_w_ptr=norm_w.data_ptr(), head_dim=head_dim, plane_h=h, ab=ab,
            stats=stats, seg_boundary=seg_boundary)
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# Transposed products (the backward of the int8 linears)
# ---------------------------------------------------------------------------


def _launch_t(name: str, dy: torch.Tensor, w_ptr: int, k: int, n: int,
              scale_ptr: int) -> torch.Tensor:
    dy = dy.to(torch.bfloat16).contiguous()
    if dy.data_ptr() % 16:  # the kernels read dy in bf16 pairs or 16-byte chunks
        dy = dy.clone()
    _check(n % 16 == 0 and k % 2 == 0,
           f"transposed kernel: N {n} must be a multiple of 16, K {k} even")
    m = dy.shape[0]
    out = torch.empty(m, k, dtype=torch.bfloat16, device=dy.device)
    lib = cuda_build.library("quant_matmul_t")
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    route = active_route(qmm_t_route(k, n))
    if route == "wgmma":
        # the pre-scaled, contraction-permuted dy the wgmma kernel reads
        a = torch.empty(m, n, dtype=torch.bfloat16, device=dy.device)
        fn = lib.qmm_t_gemm_wgmma
        fn.argtypes, fn.restype = _T_WGMMA_SIGNATURE, ctypes.c_int
        code = fn(dy.data_ptr(), w_ptr, scale_ptr, a.data_ptr(),
                  out.data_ptr(), m, k, n, 1, stream)
    elif route == "narrow":
        fn = cuda_build.entry("quant_matmul_t", "qmm_t_gemm_narrow",
                              _T_SIGNATURE)
        code = fn(dy.data_ptr(), w_ptr, scale_ptr, out.data_ptr(), m, k, n,
                  stream)
    else:
        fn = lib.qmm_t_gemm
        fn.argtypes, fn.restype = _T_SIGNATURE, ctypes.c_int
        code = fn(dy.data_ptr(), w_ptr, scale_ptr, out.data_ptr(), m, k, n,
                  stream)
    cuda_build.check(code, f"qmm_t_gemm ({name}, {route})")
    cuda_build.LAUNCHES[name] += 1
    cuda_build.LAUNCHES[f"{name}:{route}"] += 1
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
    in_layout = w8a8_layout.to_kn(w_q, 0)
    if dy.device.type == "cpu":
        return qmm_t_plain(dy, w_q, scale)
    _cuda_dy(dy, n)
    _cuda_weight(w_q, dy.device, in_layout)
    _cuda_vec(scale, (1, n), "scale", dy.device)
    return _launch_t("qmm_t", dy, w_q.data_ptr(), k, n, scale.data_ptr())


def quant_matmul_t_stacked(dy: torch.Tensor, w_q3: torch.Tensor,
                           scale3: torch.Tensor, blk: int) -> torch.Tensor:
    """dx = cast(dy * scale3[blk]) @ w_q3[blk]^T without slicing the stack:
    dy [M, N], w_q3 [NB, K, N] int8, scale3 [NB, 1, N] -> [M, K]."""
    nb, k, n = w_q3.shape
    if not 0 <= blk < nb:
        raise IndexError(f"block {blk} out of range for a stack of {nb}")
    in_layout = w8a8_layout.to_kn(w_q3, 1)
    if dy.device.type == "cpu":
        return qmm_t_plain(dy, w_q3[blk], scale3[blk])
    _cuda_dy(dy, n)
    _cuda_weight(w_q3, dy.device, in_layout)
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
    def forward(ctx, x, w_q, scale, bias, w8a8):
        ctx.save_for_backward(w_q, scale)
        ctx.x_dtype = x.dtype
        return quant_matmul(x, w_q, scale, bias=bias, w8a8=w8a8)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        w_q, scale = ctx.saved_tensors
        dx = quant_matmul_t(dy, w_q, scale)
        return dx.to(ctx.x_dtype), None, None, None, None


class _QuantMatmulStackedFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q3, scale3, bias3, blk, w8a8):
        ctx.save_for_backward(w_q3, scale3)
        ctx.blk, ctx.x_dtype = blk, x.dtype
        return quant_matmul_stacked(x, w_q3, scale3, blk, bias3=bias3,
                                    w8a8=w8a8)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        w_q3, scale3 = ctx.saved_tensors
        dx = quant_matmul_t_stacked(dy, w_q3, scale3, ctx.blk)
        return dx.to(ctx.x_dtype), None, None, None, None, None


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 sums, rounded once to a's dtype.  bf16 operands on
    CUDA take cuBLAS's float32 output, so that no split-K partial sum of a
    long contraction (x A over K, the LoRA gradients over M) is rounded to
    bf16 on the way; on the CPU a bf16 product already sums in float32."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32).to(a.dtype)
    return torch.mm(a, b)


def lora_factor(x: torch.Tensor, a: torch.Tensor, ms) -> torch.Tensor:
    """The [M, r] factor of the rank-r update: bf16(x A) (float32 sums, the
    JAX package's rounding), times ``ms`` (a float32 tensor: lora_scale, or
    lora_scale times the per-row 0/1 mask as [M, 1]) with one more
    rounding."""
    xa = _mm(x, a.to(x.dtype))
    return (xa * ms).to(x.dtype)


def lora_update(y: torch.Tensor, xa_ms: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """y += xa_ms @ b in place (one GEMM that reads y, sums in float32 and
    rounds once): the QLoRA delta added to the int8 kernel's output."""
    return y.addmm_(xa_ms, b.to(y.dtype))


class _QuantLoraLinearFn(torch.autograd.Function):
    """y = x Wq scale + bias (the int8 kernel, bias in its epilogue) +
    ((x A) * ms) B (the rank-r update), differentiable in x, A and B.
    Backward: dx = qmm_t(dy) + g A^T (one addmm into the transposed
    kernel's output), dB = (x A ms)^T dy, dA = x^T g, with g = (dy B^T) * ms
    the [M, r] factor; no [M, N] or [M, K] tensor is widened."""

    @staticmethod
    def forward(ctx, x, a, b, ms, w_q, scale, bias, blk, w8a8):
        if blk is None:
            y = quant_matmul(x, w_q, scale, bias=bias, w8a8=w8a8)
        else:
            y = quant_matmul_stacked(x, w_q, scale, blk, bias3=bias, w8a8=w8a8)
        xa_ms = lora_factor(x, a, ms)
        y = lora_update(y.to(x.dtype), xa_ms, b)
        ctx.save_for_backward(x, a, b, ms, xa_ms, w_q, scale)
        ctx.blk = blk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, a, b, ms, xa_ms, w_q, scale = ctx.saved_tensors
        dy = dy.to(x.dtype)
        g = (_mm(dy, b.to(x.dtype).t()) * ms).to(x.dtype)
        dx = da = db = None
        if ctx.needs_input_grad[0]:
            if ctx.blk is None:
                dx = quant_matmul_t(dy, w_q, scale)
            else:
                dx = quant_matmul_t_stacked(dy, w_q, scale, ctx.blk)
            dx = dx.to(x.dtype).addmm_(g, a.to(x.dtype).t())
        if ctx.needs_input_grad[1]:
            da = _mm(x.t(), g).to(a.dtype)
        if ctx.needs_input_grad[2]:
            db = _mm(xa_ms.t(), dy).to(b.dtype)
        return dx, da, db, None, None, None, None, None, None


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


def _ln_stats(x: torch.Tensor):
    """(normalized x in float32, rstd [M, 1]) with the prologue's recipe."""
    stats = ln_row_stats(x)
    return (x.float() - stats[:, 0:1]) * stats[:, 1:2], stats[:, 1:2]


def _seg_sums(v: torch.Tensor, boundary: int):
    """(sum over main rows, sum over cond rows) of float32 v [M, D]."""
    cond = _seg_rows(v.shape[0], boundary, v.device)
    return (torch.where(cond, 0.0, v).sum(0), torch.where(cond, v, 0.0).sum(0))


class _QuantLnModLinearStackedFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q3, scale3, bias3, ab, blk, seg_boundary, activation,
                w8a8):
        ctx.save_for_backward(x, w_q3, scale3, bias3, ab)
        ctx.blk, ctx.boundary = blk, seg_boundary
        ctx.activation, ctx.w8a8 = activation, w8a8
        return quant_matmul_stacked(x, w_q3, scale3, blk, bias3=bias3,
                                    activation=activation, w8a8=w8a8, ab=ab,
                                    seg_boundary=seg_boundary)

    @staticmethod
    def backward(ctx, dy):
        x, w_q3, scale3, bias3, ab = ctx.saved_tensors
        m, blk, boundary = x.shape[0], ctx.blk, ctx.boundary
        xn, rstd = _ln_stats(x)
        a_seg = _seg_select(ab[0], ab[2], m, boundary)
        if ctx.activation == "gelu_tanh":
            # recompute the pre-activation through the unfused product
            x_mod = (xn * a_seg + _seg_select(ab[1], ab[3], m, boundary))
            z = quant_matmul_stacked(x_mod.to(torch.bfloat16), w_q3, scale3,
                                     blk, bias3=bias3, w8a8=ctx.w8a8)
            dz = _gelu_grad(dy, z)
        else:
            dz = dy
        dxmod = quant_matmul_t_stacked(dz, w_q3, scale3, blk).float()
        dab = None
        if ctx.needs_input_grad[4]:
            da_main, da_cond = _seg_sums(dxmod * xn, boundary)
            db_main, db_cond = _seg_sums(dxmod, boundary)
            dab = torch.zeros_like(ab)
            for row, v in enumerate((da_main, db_main, da_cond, db_cond)):
                dab[row] = v
        dx = None
        if ctx.needs_input_grad[0]:
            # layer norm backward (no learned affine)
            dn = dxmod * a_seg
            dn_mean = dn.mean(-1, keepdim=True)
            proj = (dn * xn).mean(-1, keepdim=True)
            dx = (rstd * (dn - dn_mean - xn * proj)).to(x.dtype)
        return dx, None, None, None, dab, None, None, None, None


class _QuantGateResLinearStackedFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q3, scale3, bias3, resid, gate, blk, seg_boundary,
                w8a8):
        ctx.save_for_backward(x, w_q3, scale3, bias3, gate)
        ctx.blk, ctx.boundary, ctx.w8a8 = blk, seg_boundary, w8a8
        ctx.resid_dtype = resid.dtype
        return quant_matmul_stacked(x, w_q3, scale3, blk, bias3=bias3,
                                    w8a8=w8a8, resid=resid, gate=gate,
                                    seg_boundary=seg_boundary)

    @staticmethod
    def backward(ctx, dy):
        x, w_q3, scale3, bias3, gate = ctx.saved_tensors
        m, blk, boundary = x.shape[0], ctx.blk, ctx.boundary
        dyf = dy.float()
        dx = dgate = dresid = None
        if ctx.needs_input_grad[0]:
            g_seg = _seg_select(gate[0], gate[1], m, boundary)
            dz = (dyf * g_seg).to(dy.dtype)
            dx = quant_matmul_t_stacked(dz, w_q3, scale3, blk).to(x.dtype)
        if ctx.needs_input_grad[4]:
            dresid = dy.to(ctx.resid_dtype)  # d(resid + ...)/d(resid) = 1
        if ctx.needs_input_grad[5]:
            # the forward's z: the kernel takes x as bf16
            z = quant_matmul_stacked(x.to(torch.bfloat16), w_q3, scale3, blk,
                                     bias3=bias3, w8a8=ctx.w8a8).float()
            dgate = torch.zeros_like(gate)
            dgate[0], dgate[1] = _seg_sums(dyf * z, boundary)
        return dx, None, None, None, dresid, dgate, None, None, None


def quant_ln_mod_linear_stacked(x, w_q3, scale3, bias3, ab, blk: int, *,
                                seg_boundary: int = 0,
                                activation: Optional[str] = None,
                                w8a8: bool = False):
    """act(((layernorm(x) * a_seg + b_seg) @ w_q3[blk]) * scale3[blk] +
    bias3[blk]) with the prologue in the kernel (ab [8, K] float32),
    differentiable in x and ab (the JAX package's
    quant_ln_mod_linear_stacked)."""
    return _QuantLnModLinearStackedFn.apply(x, w_q3, scale3, bias3, ab, blk,
                                            seg_boundary, activation, w8a8)


def quant_gate_res_linear_stacked(x, w_q3, scale3, bias3, resid, gate,
                                  blk: int, *, seg_boundary: int = 0,
                                  w8a8: bool = False):
    """resid + gate_seg(row) * (x @ w_q3[blk] * scale3[blk] + bias3[blk])
    with the epilogue in the kernel (gate [8, N] float32), differentiable in
    x, resid and gate (the JAX package's quant_gate_res_linear_stacked)."""
    return _QuantGateResLinearStackedFn.apply(x, w_q3, scale3, bias3, resid,
                                              gate, blk, seg_boundary, w8a8)


def quant_matmul_vjp(x, w_q, scale, *, bias=None, lora=None,
                     w8a8: bool = False):
    """`quant_matmul` (bias [1, N] float32 in the epilogue), differentiable
    in x (backward: `quant_matmul_t`); ``lora`` = (A, B, ms) adds the
    rank-r update ((x A) * ms) B, differentiable in A and B too."""
    if lora is not None:
        return _QuantLoraLinearFn.apply(x, *lora, w_q, scale, bias, None, w8a8)
    return _QuantMatmulFn.apply(x, w_q, scale, bias, w8a8)


def quant_matmul_stacked_vjp(x, w_q3, scale3, blk: int, *, bias3=None,
                             lora=None, w8a8: bool = False):
    """`quant_matmul_stacked` (bias3 [NB, 1, N] float32 in the epilogue),
    differentiable in x (backward: `quant_matmul_t_stacked`); ``lora`` as
    in `quant_matmul_vjp`."""
    if lora is not None:
        return _QuantLoraLinearFn.apply(x, *lora, w_q3, scale3, bias3, blk,
                                        w8a8)
    return _QuantMatmulStackedFn.apply(x, w_q3, scale3, bias3, blk, w8a8)


def quant_linear_gelu_stacked(x, w_q3, scale3, bias3, blk: int, *,
                              w8a8: bool = False):
    """gelu_tanh(x @ w_q3[blk] * scale3[blk] + bias3[blk]) with the fused
    epilogue, differentiable in x (recompute backward)."""
    return _QuantLinearGeluStackedFn.apply(x, w_q3, scale3, bias3, blk, w8a8)


def quant_linear_gelu(x, w_q, scale, bias, *, w8a8: bool = False):
    """gelu_tanh(x @ w_q * scale + bias) with the fused epilogue (bias
    [1, N] float32), differentiable in x (recompute backward)."""
    return _QuantLinearGeluFn.apply(x, w_q, scale, bias, w8a8)
