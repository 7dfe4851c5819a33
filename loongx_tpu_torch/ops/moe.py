"""The sparse-expert feed-forward: a softmax router's top-k of E routed
SwiGLU experts, weighted by their router probabilities (not renormalised),
plus a shared SwiGLU expert on every token, with no capacity limit (no
token is dropped).  The kernels are ``csrc/moe_gemm.cu``; every step's row
counts stay on the device, so an expert layer makes no host synchronization.

One layer (`expert_layer`), W8A8 on a CUDA tensor:

  1. `route`: router logits and softmax in float32, the top k;
  2. `plan`: each expert's row count and, by a prefix sum, its rows' start
     in a grouped buffer, padded up to the GEMM's 128-row tile; each
     (token, slot)'s row there, the token of each row (-1 on padding) and
     its routing weight.  The buffer's size is known on the host: k M rows
     and at most 127 rows of padding an expert (`capacity`);
  3. `quant_rows`: the W8A8 codes of x per (row, group), once in token
     order (the shared expert's input) and once gathered into the grouped
     buffer (the routed experts');
  4. `grouped_gemm` with the SwiGLU epilogue: one launch over every routed
     expert, N = 2F (W1 and W3 fused into one [D, 2F] weight whose columns
     are interleaved per 128-wide tile, `interleave_swiglu`), h = silu(x W1)
     * (x W3) in bf16; one more launch, one group of every token, for the
     shared expert;
  5. `quant_rows` of both h;
  6. `grouped_gemm` with the rows epilogue: the routed down products, each
     row scaled by its routing weight, in one launch; the shared one;
  7. `combine`: resid + gate * (the token's routed rows + its shared row),
     a gather, no atomics.

A dense SwiGLU (`swiglu_layer`) runs the same kernels as one group.  The
grouped GEMM reads its weight stacks K-major (`ops.w8a8_layout`: each
[K, N] slice stored transposed, the strides the marker): a launch makes a
whole stack K-major in place, and `kmajor_stacks` makes every stack of a
serving tree K-major before its blocks index them (a block's view of a
[NB, E, K, N] stack cannot move by itself).  The
activation group of a W8A8 product is `expert_group(K)`: the largest
multiple of 128 up to 2560 that divides K (2560 at K 2560, 2304 at 6912,
1792 at 3584), K itself where none does (the tiny test widths).

On CPU tensors each step runs its plain version, the kernel's arithmetic
in PyTorch (float32 activations run the float products of the dequantised
weights).  Each kernel launch counts under its name in
`cuda_build.LAUNCHES` (``moe_route``, ``moe_plan``, ``moe_quant``,
``moe_gemm``, ``moe_combine``).  While spans record (`utils.profiling`),
each routing step adds its expert row counts into the device counter
``moe.expert_rows`` (`profiling.count_into`); the span ``dit.moe`` covers a
layer, ``dit.moe.experts`` its grouped GEMMs.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from loongx_tpu_torch.ops import cuda_build, w8a8_layout
from loongx_tpu_torch.utils import profiling
from loongx_tpu_torch.utils.profiling import span

ROW_TILE = 128  # the grouped GEMM's M tile: each group's rows start on a multiple
GROUP_MAX = 2560  # the widest activation group the quantization pass holds
SWIGLU_HALF = 64  # gate (then up) columns a 128-wide tile of a fused W1|W3
EPI_SWIGLU, EPI_ROWS = 0, 1
COUNTER = "moe.expert_rows"

_P, _I = ctypes.c_void_p, ctypes.c_int
_ROUTE_SIGNATURE = [_P, _P, _I, _I, _I, _I, _P, _P, _P]
_PLAN_SIGNATURE = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]
_QUANT_SIGNATURE = [_P, _P, _P, _I, _I, _I, _P, _P, _P]
_GEMM_SIGNATURE = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_COMBINE_SIGNATURE = [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P]


def expert_group(k: int) -> int:
    """The W8A8 activation group of a K-wide expert input (module
    docstring)."""
    for g in range(min(k, GROUP_MAX) // ROW_TILE * ROW_TILE, 0, -ROW_TILE):
        if k % g == 0:
            return g
    return k


def capacity(pairs: int, experts: int) -> int:
    """Rows of the grouped buffer: every (token, slot) pair and at most 127
    rows of padding an expert, whole 128-row tiles."""
    rows = pairs + (ROW_TILE - 1) * experts
    return -(-rows // ROW_TILE) * ROW_TILE


def gemm_ok(k: int, n: int) -> bool:
    """Does the grouped GEMM take a [K, N] weight: K and N whole 128
    tiles?"""
    return k % ROW_TILE == 0 and n % ROW_TILE == 0 and k > 0 and n > 0


def kmajor_stacks(tree) -> None:
    """Make every expert stack of ``tree`` (its ``w13_q`` / ``w2_q``
    leaves, [E, K, N] or a block stack [NB, E, K, N]) K-major in place
    where the grouped GEMM takes its shape; a stack already K-major costs a
    look at its strides."""
    if not isinstance(tree, dict):
        return
    for key, v in tree.items():
        if key in ("w13_q", "w2_q") and isinstance(v, torch.Tensor):
            if gemm_ok(v.shape[-2], v.shape[-1]):
                w8a8_layout.to_kmajor(v, v.ndim - 2)
        else:
            kmajor_stacks(v)


def interleave_swiglu(w1: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """[..., K, F] W1 and W3 (or [..., 1, F] scales) -> [..., K, 2F]: each
    128-wide column tile holds 64 columns of W1, then the same 64 of W3."""
    *lead, k, f = w1.shape
    if f % SWIGLU_HALF:
        raise ValueError(f"SwiGLU width {f} not a multiple of {SWIGLU_HALF}")
    shape = (*lead, k, f // SWIGLU_HALF, 1, SWIGLU_HALF)
    both = torch.cat([w1.reshape(shape), w3.reshape(shape)], dim=-2)
    return both.reshape(*lead, k, 2 * f)


def split_swiglu(w13: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `interleave_swiglu`: (W1, W3)."""
    *lead, k, f2 = w13.shape
    x = w13.reshape(*lead, k, f2 // (2 * SWIGLU_HALF), 2, SWIGLU_HALF)
    return (x[..., 0, :].reshape(*lead, k, f2 // 2),
            x[..., 1, :].reshape(*lead, k, f2 // 2))


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors)
# ---------------------------------------------------------------------------


def route_plain(x: torch.Tensor, w_gate: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [M, D], w_gate [E, D] -> (idx int32 [M, k], weights float32 [M, k]):
    softmax of the float32 logits, the largest first, ties to the lower
    index."""
    probs = torch.softmax(x.float() @ w_gate.float().t(), dim=-1)
    left, idx, wts = probs.clone(), [], []
    for _ in range(top_k):
        i = torch.argmax(left, dim=-1)
        idx.append(i)
        wts.append(probs.gather(1, i[:, None])[:, 0])
        left = left.scatter(1, i[:, None], float("-inf"))
    return (torch.stack(idx, 1).to(torch.int32), torch.stack(wts, 1))


def plan_plain(idx: torch.Tensor, wts: torch.Tensor, experts: int, cap: int):
    """The kernel's plan: (counts [E], offsets [E + 1], dest [M, k], src
    [cap], row_w [cap])."""
    flat = idx.reshape(-1).long()
    onehot = F.one_hot(flat, experts)
    counts = onehot.sum(0)
    padded = -(-counts // ROW_TILE) * ROW_TILE
    offsets = torch.cat([counts.new_zeros(1), padded.cumsum(0)])
    rank = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    dest = offsets[flat] + rank
    src = torch.full((cap,), -1, dtype=torch.int32, device=idx.device)
    row_w = torch.zeros(cap, dtype=torch.float32, device=idx.device)
    src[dest] = (torch.arange(flat.numel(), device=idx.device)
                 // idx.shape[1]).to(torch.int32)
    row_w[dest] = wts.reshape(-1).float()
    return (counts.to(torch.int32), offsets.to(torch.int32),
            dest.reshape(idx.shape).to(torch.int32), src, row_w)


def quant_rows_plain(x: torch.Tensor, group: int,
                     src: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8 [R, K], scales float32 [R, K / group]) of bf16(x) (rows
    through ``src``: -1 gives zero codes and scale 1)."""
    xf = x.to(torch.bfloat16).float()
    if src is not None:
        keep = (src >= 0)[:, None]
        xf = torch.where(keep, xf[src.clamp(min=0).long()], 0.0)
    r, k = xf.shape
    xg = xf.view(r, k // group, group)
    absmax = xg.abs().amax(-1)
    xs = torch.where(absmax == 0, torch.ones_like(absmax),
                     absmax / absmax.new_full((), 127.0))
    q = torch.clamp(torch.round(xg / xs[..., None]), -127, 127)
    return q.view(r, k).to(torch.int8), xs


def grouped_gemm_plain(codes, xs, w, scale, epilogue: int,
                       offsets=None, counts=None, row_w=None) -> torch.Tensor:
    """The grouped GEMM's arithmetic: per activation group integer products
    rescaled into float32, times the weight scale, then the epilogue, one
    bf16 cast.  Rows outside every group come out 0."""
    g_count, k, n = w.shape
    m = codes.shape[0]
    group = k // xs.shape[1]
    out_n = n // 2 if epilogue == EPI_SWIGLU else n
    out = torch.zeros(m, out_n, dtype=torch.float32, device=codes.device)
    bounds = ([(0, m)] if offsets is None else
              [(int(offsets[g]), int(offsets[g]) + int(counts[g]))
               for g in range(g_count)])
    for g, (r0, r1) in enumerate(bounds):
        if r1 <= r0:
            continue
        a, wf = codes[r0:r1].float(), w[g].float()
        acc = torch.zeros(r1 - r0, n, dtype=torch.float32, device=codes.device)
        for gi in range(k // group):
            part = slice(gi * group, (gi + 1) * group)
            acc = acc + (a[:, part] @ wf[part]) * xs[r0:r1, gi:gi + 1]
        z = acc * scale[g].reshape(1, n).float()
        if epilogue == EPI_SWIGLU:
            gate, up = split_swiglu(z)
            z = F.silu(gate) * up
        elif row_w is not None:
            z = z * row_w[r0:r1, None]
        out[r0:r1] = z
    return out.to(torch.bfloat16)


def combine_plain(resid, gate, y_routed, dest, y_shared, rows_per_batch: int,
                  boundary: int) -> torch.Tensor:
    """resid + gate[b, seg] * (routed rows in slot order + shared row) in
    float32, one cast to resid's dtype."""
    m = resid.shape[0]
    acc = None
    if dest is not None:
        for k in range(dest.shape[1]):
            row = y_routed[dest[:, k].long()].float()
            acc = row if acc is None else acc + row
    acc = y_shared.float() if acc is None else acc + y_shared.float()
    t = torch.arange(m, device=resid.device)
    sel = 2 * (t // rows_per_batch) + ((t % rows_per_batch) >= boundary).long()
    g = gate.reshape(-1, gate.shape[-1]).float()[sel]
    return (resid.float() + g * acc).to(resid.dtype)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _operand(t: torch.Tensor, dtype: torch.dtype, shape, what: str,
             device) -> torch.Tensor:
    """``t`` as the kernels take it: contiguous, of ``dtype`` and ``shape``
    on ``device``, or a ValueError naming ``what``."""
    _check(t.dtype == dtype and tuple(t.shape) == tuple(shape)
           and t.device == device and t.is_contiguous(),
           f"{what} must be contiguous {dtype} {tuple(shape)} on {device}, "
           f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t


def _bf16(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.bfloat16).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def route(x: torch.Tensor, w_gate: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx int32 [M, k], weights float32 [M, k]) of x [M, D] under the
    router w_gate [E, D] (`route_plain` on CPU)."""
    if x.device.type == "cpu":
        return route_plain(x, w_gate, top_k)
    m, d = x.shape
    e = w_gate.shape[0]
    _check(tuple(w_gate.shape) == (e, d) and w_gate.device == x.device,
           f"router weight must be [E, {d}] on {x.device}, got "
           f"{tuple(w_gate.shape)} on {w_gate.device}")
    xb, wg = _bf16(x), w_gate.float().contiguous()
    idx = torch.empty(m, top_k, dtype=torch.int32, device=x.device)
    wts = torch.empty(m, top_k, dtype=torch.float32, device=x.device)
    fn = cuda_build.entry("moe_gemm", "moe_route", _ROUTE_SIGNATURE)
    cuda_build.check(fn(xb.data_ptr(), wg.data_ptr(), m, d, e, top_k,
                        idx.data_ptr(), wts.data_ptr(), _stream(x)), "moe_route")
    cuda_build.LAUNCHES["moe_route"] += 1
    return idx, wts


def plan(idx: torch.Tensor, wts: torch.Tensor, experts: int, cap: int):
    """(counts [E], offsets [E + 1], dest [M, k], src [cap], row_w [cap]) of
    a routing (`plan_plain` on CPU)."""
    if idx.device.type == "cpu":
        return plan_plain(idx, wts, experts, cap)
    dev = idx.device
    _check(idx.dtype == torch.int32 and idx.ndim == 2
           and tuple(wts.shape) == tuple(idx.shape),
           f"routing: idx int32 [M, k] with weights alike, got {idx.dtype} "
           f"{tuple(idx.shape)} and {tuple(wts.shape)}")
    idx, wts = idx.contiguous(), wts.float().contiguous()
    counts = torch.empty(experts, dtype=torch.int32, device=dev)
    offsets = torch.empty(experts + 1, dtype=torch.int32, device=dev)
    dest = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    src = torch.empty(cap, dtype=torch.int32, device=dev)
    row_w = torch.empty(cap, dtype=torch.float32, device=dev)
    fn = cuda_build.entry("moe_gemm", "moe_plan", _PLAN_SIGNATURE)
    cuda_build.check(fn(idx.data_ptr(), wts.data_ptr(), idx.numel(),
                        idx.shape[1], experts, cap, counts.data_ptr(),
                        offsets.data_ptr(), dest.data_ptr(), src.data_ptr(),
                        row_w.data_ptr(), _stream(idx)), "moe_plan")
    cuda_build.LAUNCHES["moe_plan"] += 1
    return counts, offsets, dest, src, row_w


def quant_rows(x: torch.Tensor, group: int, src: Optional[torch.Tensor] = None,
               limit: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8 [R, K], scales float32 [R, K / group]) of x [*, K]: its
    rows in order, or through ``src`` [R] (-1: zero codes, scale 1); rows
    at or past the device count ``limit`` (int32 [1]) are left unwritten
    (`quant_rows_plain` on CPU)."""
    if x.device.type == "cpu":
        return quant_rows_plain(x, group, src)
    k = x.shape[1]
    r = x.shape[0] if src is None else src.shape[0]
    xb = _bf16(x)
    codes = torch.empty(r, k, dtype=torch.int8, device=x.device)
    scales = torch.empty(r, k // group, dtype=torch.float32, device=x.device)
    fn = cuda_build.entry("moe_gemm", "moe_quant", _QUANT_SIGNATURE)
    cuda_build.check(fn(xb.data_ptr(), _ptr(src), _ptr(limit), r, k, group,
                        codes.data_ptr(), scales.data_ptr(), _stream(x)),
                     "moe_quant")
    cuda_build.LAUNCHES["moe_quant"] += 1
    return codes, scales


def grouped_gemm(codes: torch.Tensor, xs: torch.Tensor, w: torch.Tensor,
                 scale: torch.Tensor, epilogue: int,
                 offsets: Optional[torch.Tensor] = None,
                 counts: Optional[torch.Tensor] = None,
                 row_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codes int8 [M, K] (scales xs [M, K / group]) through the stack w int8
    [G, K, N] (scale [G, 1, N]), group g over rows [offsets[g], offsets[g] +
    counts[g]) (None: one group of every row) -> bf16 [M, N / 2] (SwiGLU)
    or [M, N] (rows, times ``row_w`` where given); one launch
    (`grouped_gemm_plain` on CPU).  The kernel reads ``w`` K-major: a
    stack of its own (or a view of the whole of one) is made K-major in
    place first."""
    g, k, n = w.shape
    kmajor = gemm_ok(k, n) and w8a8_layout.to_kmajor(w, 1)
    if codes.device.type == "cpu":
        return grouped_gemm_plain(codes, xs, w, scale, epilogue, offsets,
                                  counts, row_w)
    m, dev = codes.shape[0], codes.device
    _operand(codes, torch.int8, (m, k), "codes", dev)
    _check(xs.ndim == 2 and xs.shape[1] > 0 and k % xs.shape[1] == 0,
           f"scales {tuple(xs.shape)} do not split K {k} into groups")
    _operand(xs, torch.float32, (m, xs.shape[1]), "scales", dev)
    _check(w.dtype == torch.int8 and w.device == dev and kmajor,
           f"weight stack must be int8 [G, K, N] on {dev}, K and N whole 128 "
           f"tiles, K-major or able to become so in place (a stack of its "
           f"own); got {w.dtype} {tuple(w.shape)} strides {w.stride()} on "
           f"{w.device}")
    _operand(scale, torch.float32, (g, 1, n), "weight scales", dev)
    if offsets is not None:
        _operand(offsets, torch.int32, (g + 1,), "offsets", dev)
        _operand(counts, torch.int32, (g,), "counts", dev)
    if row_w is not None:
        _operand(row_w, torch.float32, (m,), "row weights", dev)
    out = torch.empty(m, n // 2 if epilogue == EPI_SWIGLU else n,
                      dtype=torch.bfloat16, device=codes.device)
    fn = cuda_build.entry("moe_gemm", "moe_gemm", _GEMM_SIGNATURE)
    cuda_build.check(fn(epilogue, codes.data_ptr(), xs.data_ptr(), w.data_ptr(),
                        scale.data_ptr(), _ptr(row_w), _ptr(offsets),
                        _ptr(counts), out.data_ptr(), m, k, n, g,
                        k // xs.shape[1], _stream(codes)), "moe_gemm")
    cuda_build.LAUNCHES["moe_gemm"] += 1
    return out


def combine(resid: torch.Tensor, gate: torch.Tensor,
            y_routed: Optional[torch.Tensor], dest: Optional[torch.Tensor],
            y_shared: torch.Tensor, rows_per_batch: int,
            boundary: int) -> torch.Tensor:
    """resid [M, D] + gate[b, seg] * (y_routed[dest[t, :]] summed in slot
    order + y_shared[t]); gate float32 [B, 2, D] (the main and the cond
    segment's), row t in batch t // rows_per_batch, cond where t %
    rows_per_batch >= boundary (`combine_plain` on CPU)."""
    if resid.device.type == "cpu":
        return combine_plain(resid, gate, y_routed, dest, y_shared,
                             rows_per_batch, boundary)
    m, d = resid.shape
    _check(tuple(y_shared.shape) == (m, d) and tuple(gate.shape[-2:]) == (2, d)
           and (dest is None or (dest.dtype == torch.int32
                                 and dest.shape[0] == m)),
           f"combine: resid {tuple(resid.shape)}, shared rows "
           f"{tuple(y_shared.shape)}, gate {tuple(gate.shape)} do not agree")
    rb, ys = _bf16(resid), _bf16(y_shared)
    yr = None if y_routed is None else _bf16(y_routed)
    gate = gate.float().contiguous()
    out = torch.empty(m, d, dtype=torch.bfloat16, device=resid.device)
    fn = cuda_build.entry("moe_gemm", "moe_combine", _COMBINE_SIGNATURE)
    top_k = 0 if dest is None else dest.shape[1]
    cuda_build.check(fn(rb.data_ptr(), gate.data_ptr(), _ptr(yr), _ptr(dest),
                        top_k, ys.data_ptr(), out.data_ptr(), m, d,
                        rows_per_batch, boundary, _stream(resid)),
                     "moe_combine")
    cuda_build.LAUNCHES["moe_combine"] += 1
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _dequant(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Row-major float32 (the same products from either int8 layout)."""
    return (w.float() * scale.float()).contiguous()


def _float_swiglu(x: torch.Tensor, p: Dict[str, torch.Tensor], g: int
                  ) -> torch.Tensor:
    """Weight-only float32 product of group g of a SwiGLU stack."""
    h = x.float() @ _dequant(p["w13_q"][g], p["w13_scale"][g])
    gate, up = split_swiglu(h)
    return (F.silu(gate) * up) @ _dequant(p["w2_q"][g], p["w2_scale"][g])


def _swiglu_w8a8(x_codes, x_scales, p, offsets=None, counts=None,
                 row_w=None, limit=None) -> torch.Tensor:
    h = grouped_gemm(x_codes, x_scales, p["w13_q"], p["w13_scale"],
                     EPI_SWIGLU, offsets, counts)
    h_codes, h_scales = quant_rows(h, expert_group(h.shape[1]), limit=limit)
    return grouped_gemm(h_codes, h_scales, p["w2_q"], p["w2_scale"], EPI_ROWS,
                        offsets, counts, row_w)


def swiglu_layer(x: torch.Tensor, p: Dict[str, torch.Tensor], resid,
                 gate: torch.Tensor, rows_per_batch: int, boundary: int,
                 w8a8: bool = True) -> torch.Tensor:
    """resid + gate_seg * SwiGLU(x) for the one-group stack ``p``
    ({w13_q [1, D, 2F], w13_scale [1, 1, 2F], w2_q [1, F, D], w2_scale
    [1, 1, D]}), x / resid [M, D]."""
    if not w8a8:
        return combine_plain(resid, gate, None, None, _float_swiglu(x, p, 0),
                             rows_per_batch, boundary)
    codes, scales = quant_rows(x, expert_group(x.shape[1]))
    y = _swiglu_w8a8(codes, scales, p)
    return combine(resid, gate, None, None, y, rows_per_batch, boundary)


def expert_layer(x: torch.Tensor, p: Dict[str, torch.Tensor], resid,
                 gate: torch.Tensor, rows_per_batch: int, boundary: int,
                 top_k: int, layer: int = 0, n_layers: int = 1,
                 w8a8: bool = True) -> torch.Tensor:
    """resid + gate_seg * MoE(x) (module docstring) for x / resid [M, D]:
    ``p`` holds the router ``gate_w`` [E, D] (float32), the routed stacks
    ``experts`` ({w13_q [E, D, 2F], w13_scale [E, 1, 2F], w2_q [E, F, D],
    w2_scale [E, 1, D]}) and the one-group ``shared`` stack.  ``layer`` of
    ``n_layers`` indexes the row counter.  Without ``w8a8`` (float32
    activations, CPU tests) the products are float32 over the dequantised
    weights."""
    with span("dit.moe"):
        experts = p["experts"]
        e = experts["w13_q"].shape[0]
        idx, wts = route(x, p["gate_w"], top_k)
        cap = capacity(idx.numel(), e)
        counts, offsets, dest, src, row_w = plan(idx, wts, e, cap)
        if profiling.recording():
            profiling.count_into(COUNTER, layer, n_layers, counts)
        if not w8a8:
            if x.device.type != "cpu":
                raise NotImplementedError(
                    "the expert layer serves W8A8 only on CUDA (w8a8=True)")
            xs = x.float()
            y_routed = torch.zeros(cap, x.shape[1], dtype=torch.float32)
            for g in range(e):
                r0, r1 = int(offsets[g]), int(offsets[g]) + int(counts[g])
                rows = src[r0:r1].long()
                y_routed[r0:r1] = (_float_swiglu(xs[rows], experts, g)
                                   * row_w[r0:r1, None])
            y_shared = _float_swiglu(xs, p["shared"], 0)
            return combine_plain(resid, gate, y_routed, dest, y_shared,
                                 rows_per_batch, boundary)
        x_codes, x_scales = quant_rows(x, expert_group(x.shape[1]))
        g_codes, g_scales = quant_rows(x, expert_group(x.shape[1]), src=src)
        with span("dit.moe.experts"):
            y_routed = _swiglu_w8a8(g_codes, g_scales, experts, offsets,
                                    counts, row_w, limit=offsets[e:])
            y_shared = _swiglu_w8a8(x_codes, x_scales, p["shared"])
        return combine(resid, gate, y_routed, dest, y_shared, rows_per_batch,
                       boundary)
