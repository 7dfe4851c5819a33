"""Plain FLUX.1 forward in float32 over int8 linears: the reference the
benchmark holds the served denoise and the QLoRA step against.

It reads the unfused tree of `layout.flux_layout` (q, k and v apart,
proj_out whole) and works out itself what a serving layout derives from it.
Every activation is float32.  A linear dequantises its int8 codes with
their per-channel scales, or, in W8A8, quantizes its float32 input per
(row, k-group) -- scale = absmax / qmax, codes = clip(round(x / scale),
+-qmax) -- and sums each group's integer products in float32 (exact on
integer operands, so they may run on TF32 tensor cores), each rescaled by
its row's group scale.  The controls (`Linears`) compute the same products
one precision below the configuration's.

The group of a W8A8 linear is the configuration's (`w8a8_group`): 3072 in
the block stacks, 1024 or 1536 (clamped to K rounded up to 128) in the flat
linears, K zero-padded to whole groups.

Nothing here imports the measured package.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tree = Dict[str, Any]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def w8a8_group(k: int, n: int, stacked: bool) -> Tuple[int, int]:
    """(group, padded K) of a W8A8 linear of the configuration: the block
    stacks' k tile (3072 at every FLUX width, K 12288 and 15360 included),
    the flat linears' 1024 where N >= 4K else 1536, clamped to
    round_up(K, 128)."""
    if stacked:
        for bk in (3072, 2048, 2560, 1280):
            if k % bk == 0:
                return bk, k
    group = 1024 if n >= 4 * k else 1536
    group = min(group, _round_up(k, 128))
    return group, _round_up(k, group)


@contextlib.contextmanager
def integer_products():
    """TF32 on for products of integer-valued float32 operands (codes of at
    most 127 are exact in TF32's 10-bit mantissa), off again after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float8_e4m3fn).float()


def quantize_groups(x: torch.Tensor, group: int, k_pad: int, qmax: int):
    """float32 x [M, K] -> (integer-valued codes [M, k_pad], scales
    [M, k_pad // group])."""
    x = F.pad(x, (0, k_pad - x.shape[-1]))
    xg = x.view(x.shape[0], k_pad // group, group)
    absmax = xg.abs().amax(-1)
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        absmax / float(qmax))
    codes = torch.clamp(torch.round(xg / scale[..., None]), -qmax, qmax)
    return codes.view(x.shape[0], k_pad), scale


QMAX = {"int8": 127, "int4": 7}


class Linears:
    """How the int8 linears of one forward compute: ``acts`` "float32"
    (weight-only: float32 activations), "int8" (W8A8, the served
    configuration), or a control's precision ("int4" below the served int8;
    "fp8" below the trained bfloat16: every linear's input and output
    rounded to e4m3); and the trainable LoRA factors
    {path: {lora_a, lora_b}} with their scale (alpha / r).  Without a
    gradient the W8A8 products are the exact integer ones; with one, the
    quantized activations pass their gradient straight through."""

    def __init__(self, acts: str = "float32",
                 lora: Optional[Dict[str, Tree]] = None,
                 lora_scale: float = 1.0):
        if acts not in ("float32", "fp8", *QMAX):
            raise ValueError(f"unknown activation precision {acts!r}")
        self.acts, self.lora, self.lora_scale = acts, lora or {}, lora_scale

    def __call__(self, p: Tree, x: torch.Tensor, blk: Optional[int] = None,
                 path: str = "", lora_mask: Optional[torch.Tensor] = None,
                 use_lora: bool = True) -> torch.Tensor:
        """y = x W + b (+ (x A) B * scale * mask) for float32 x [..., K];
        ``blk`` picks one block of a stack."""
        codes, scale, bias = p["kernel_q"], p["kernel_scale"], p["bias"]
        if blk is not None:
            codes, scale, bias = codes[blk], scale[blk], bias[blk]
        lead, k = x.shape[:-1], x.shape[-1]
        n = codes.shape[-1]
        x2 = x.reshape(-1, k).float()
        wf = codes.float()
        qmax = QMAX.get(self.acts)
        if qmax is not None and not x2.requires_grad:
            group, k_pad = w8a8_group(k, n, blk is not None)
            xq, xs = quantize_groups(x2, group, k_pad, qmax)
            wf = F.pad(wf, (0, 0, 0, k_pad - k))
            acc = torch.zeros(x2.shape[0], n, dtype=torch.float32,
                              device=x.device)
            with integer_products():
                for g in range(k_pad // group):
                    part = slice(g * group, (g + 1) * group)
                    acc += (xq[:, part] @ wf[part]) * xs[:, g:g + 1]
            y = acc * scale.reshape(1, n).float()
        else:
            xin, xd = x2, x2.detach()
            if qmax is not None:
                group, k_pad = w8a8_group(k, n, blk is not None)
                xq, xs = quantize_groups(xd, group, k_pad, qmax)
                deq = (xq.view(-1, k_pad // group, group) * xs[..., None])
                xin = x2 + (deq.view(-1, k_pad)[:, :k] - xd)
            elif self.acts == "fp8":
                xin = x2 + (_fp8(xd) - xd)
            y = xin @ (wf * scale.reshape(1, n).float())
        y = y + bias.float()
        if self.acts == "fp8":  # the output stored in fp8 as well
            yd = y.detach()
            y = y + (_fp8(yd) - yd)
        lora = self.lora.get(path)
        if use_lora and lora is not None:
            a, b = lora["lora_a"], lora["lora_b"]
            if blk is not None:
                a, b = a[blk], b[blk]
            delta = (x2 @ a.float()) @ b.float() * self.lora_scale
            if lora_mask is not None:
                delta = delta * lora_mask.reshape(-1, 1)
            y = y + delta
        return y.reshape(*lead, n)


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        weight.float()


def timestep_embedding(t: torch.Tensor, dim: int = 256,
                       max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_tables(ids: torch.Tensor, axes_dims: Sequence[int],
                theta: float = 10000.0):
    """ids [S, 3] -> (cos, sin) [S, head_dim], interleaved pairs."""
    cos, sin = [], []
    for axis, dim in enumerate(axes_dims):
        freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=ids.device) / dim)
        ang = ids[:, axis, None].float() * freqs[None, :]
        cos.append(torch.repeat_interleave(torch.cos(ang), 2, dim=-1))
        sin.append(torch.repeat_interleave(torch.sin(ang), 2, dim=-1))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D]: out[2i] = x[2i] cos - x[2i+1] sin, out[2i+1] =
    x[2i+1] cos + x[2i] sin."""
    pair = x.unflatten(-1, (-1, 2))
    rot = torch.stack([-pair[..., 1], pair[..., 0]], dim=-1).flatten(-2)
    return x * cos + rot * sin


def attention(q, k, v, rope) -> torch.Tensor:
    """Full attention over [B, S, H, D] q / k / v (every token sees every
    token), RoPE on q and k; -> [B, S, H * D]."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    b, h, s, d = q.shape
    q, k, v = (t.reshape(b * h, s, d) for t in (q, k, v))
    out = q.new_empty(b * h, s, d)
    rows = max(1, (1 << 28) // (s * s))  # score blocks of at most 1 GiB
    for i in range(0, b * h, rows):
        scores = q[i:i + rows] @ k[i:i + rows].transpose(-1, -2)
        out[i:i + rows] = torch.softmax(scores / math.sqrt(d), -1) @ \
            v[i:i + rows]
    out = out.view(b, h, s, d)
    return out.transpose(1, 2).reshape(b, s, h * d)


def _seg(x: torch.Tensor, boundary: int, main: torch.Tensor,
         cond: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-row-segment operand [B, S, N] of a fused [main | cond] stream."""
    if cond is None:
        return main[:, None, :].expand(x.shape[0], x.shape[1], -1)
    rows = torch.arange(x.shape[1], device=x.device) < boundary
    return torch.where(rows[None, :, None], main[:, None, :],
                       cond[:, None, :])


def _qkv(lin: Linears, attn: Tree, x, blk, heads, names, norms, path,
         mask, use_lora):
    out = []
    for name in names:
        y = lin(attn[name], x, blk, f"{path}/{name}", mask, use_lora)
        out.append(y.reshape(*y.shape[:2], heads, -1))
    q, k, v = out
    return (rms_norm(q, attn[norms[0]]["weight"][blk]),
            rms_norm(k, attn[norms[1]]["weight"][blk]), v)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def flux_forward(p: Tree, cfg: Dict[str, Any], lin: Linears, *,
                 img: torch.Tensor, txt: torch.Tensor, pooled: torch.Tensor,
                 timestep: torch.Tensor, guidance: Optional[torch.Tensor],
                 img_ids: torch.Tensor, txt_ids: torch.Tensor,
                 cond: torch.Tensor, cond_ids: torch.Tensor,
                 checkpoint_blocks: bool = False) -> torch.Tensor:
    """The conditioned FLUX forward in float32 -> velocity [B, S_img, C].
    img / cond [B, S, C] packed latent tokens, txt [B, 512, joint], pooled
    [B, pooled], timestep and guidance [B] (scaled by 1000 here), the
    condition tokens at timestep 0 in the union attention (every token sees
    every token), LoRA on the condition tokens only.
    ``checkpoint_blocks`` recomputes each block in the backward."""
    heads = cfg["num_attention_heads"]
    img, txt, pooled, cond = (t.float() for t in (img, txt, pooled, cond))
    b, s_img, s_cond = img.shape[0], img.shape[1], cond.shape[1]
    dev = img.device

    img_h = lin(p["x_embedder"], img, path="x_embedder", use_lora=False)
    cond_h = lin(p["x_embedder"], cond, path="x_embedder")
    txt_h = lin(p["context_embedder"], txt)

    def mlp(q, x):
        return lin(q["out_layer"], F.silu(lin(q["in_layer"], x)))

    def temb_at(t):
        e = mlp(p["time_in"], timestep_embedding(t * 1000.0))
        if cfg["guidance_embeds"]:
            e = e + mlp(p["guidance_in"],
                        timestep_embedding(guidance.float() * 1000.0))
        return e + mlp(p["vector_in"], pooled)

    temb = temb_at(timestep.float())
    cond_temb = temb_at(torch.zeros_like(timestep, dtype=torch.float32))
    rope = rope_tables(torch.cat([txt_ids, img_ids, cond_ids]),
                       cfg["axes_dims_rope"])
    # LoRA rows of the modulation matvecs: [temb rows | cond_temb rows]
    mod_mask = torch.cat([torch.zeros(b, device=dev),
                          torch.ones(b, device=dev)])
    lat_mask = torch.cat([torch.zeros(s_img, device=dev),
                          torch.ones(s_cond, device=dev)]).repeat(b)
    both = F.silu(torch.cat([temb, cond_temb]))
    dbl, sgl = p["double_blocks"], p["single_blocks"]

    def double(i, txt_h, lat):
        pre = "double_blocks"
        mod = lin(dbl["norm1"]["linear"], both, i, f"{pre}/norm1/linear",
                  mod_mask)
        mi, mc = mod[:b].chunk(6, -1), mod[b:].chunk(6, -1)
        mt = lin(dbl["norm1_context"]["linear"], F.silu(temb), i).chunk(6, -1)
        a = dbl["attn"]
        n_lat = (layer_norm(lat) * (1.0 + _seg(lat, s_img, mi[1], mc[1]))
                 + _seg(lat, s_img, mi[0], mc[0]))
        n_txt = layer_norm(txt_h) * (1.0 + mt[1][:, None]) + mt[0][:, None]
        q_l, k_l, v_l = _qkv(lin, a, n_lat, i, heads, ("to_q", "to_k", "to_v"),
                             ("norm_q", "norm_k"), f"{pre}/attn", lat_mask,
                             True)
        q_t, k_t, v_t = _qkv(lin, a, n_txt, i, heads,
                             ("add_q_proj", "add_k_proj", "add_v_proj"),
                             ("norm_added_q", "norm_added_k"), "", None, False)
        out = attention(torch.cat([q_t, q_l], 1), torch.cat([k_t, k_l], 1),
                        torch.cat([v_t, v_l], 1), rope)
        s_txt = txt_h.shape[1]
        attn_lat = lin(a["to_out"], out[:, s_txt:], i, f"{pre}/attn/to_out",
                       lat_mask)
        lat = lat + _seg(lat, s_img, mi[2], mc[2]) * attn_lat
        txt_h = txt_h + mt[2][:, None] * lin(a["to_add_out"], out[:, :s_txt], i)
        n2 = (layer_norm(lat) * (1.0 + _seg(lat, s_img, mi[4], mc[4]))
              + _seg(lat, s_img, mi[3], mc[3]))
        h = F.gelu(lin(dbl["ff"]["in"], n2, i), approximate="tanh")
        lat = lat + _seg(lat, s_img, mi[5], mc[5]) * lin(
            dbl["ff"]["out"], h, i, f"{pre}/ff/out", lat_mask)
        n2t = layer_norm(txt_h) * (1.0 + mt[4][:, None]) + mt[3][:, None]
        ht = F.gelu(lin(dbl["ff_context"]["in"], n2t, i), approximate="tanh")
        txt_h = txt_h + mt[5][:, None] * lin(dbl["ff_context"]["out"], ht, i)
        return txt_h, lat

    def single(i, full, s_x):
        pre = "single_blocks"
        mask = torch.cat([torch.zeros(s_x, device=dev),
                          torch.ones(s_cond, device=dev)]).repeat(b)
        mod = lin(sgl["norm"]["linear"], both, i, f"{pre}/norm/linear",
                  mod_mask)
        mx, mc = mod[:b].chunk(3, -1), mod[b:].chunk(3, -1)
        normed = (layer_norm(full) * (1.0 + _seg(full, s_x, mx[1], mc[1]))
                  + _seg(full, s_x, mx[0], mc[0]))
        mlp_h = F.gelu(lin(sgl["proj_mlp"], normed, i, f"{pre}/proj_mlp",
                           mask), approximate="tanh")
        q, k, v = _qkv(lin, sgl["attn"], normed, i, heads,
                       ("to_q", "to_k", "to_v"), ("norm_q", "norm_k"),
                       f"{pre}/attn", mask, True)
        out = attention(q, k, v, rope)
        y = lin(sgl["proj_out"], torch.cat([out, mlp_h], -1), i,
                f"{pre}/proj_out", mask)
        return full + _seg(full, s_x, mx[2], mc[2]) * y

    def run(fn, *args):
        if checkpoint_blocks and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
        return fn(*args)

    lat = torch.cat([img_h, cond_h], 1)
    for i in range(dbl["ff"]["in"]["kernel_q"].shape[0]):
        txt_h, lat = run(double, i, txt_h, lat)
    s_txt = txt_h.shape[1]
    full = torch.cat([txt_h, lat], 1)  # [txt | img | cond]
    s_x = s_txt + s_img
    for i in range(sgl["proj_mlp"]["kernel_q"].shape[0]):
        full = run(single, i, full, s_x)
    x = full[:, s_txt:s_x]
    scale, shift = lin(p["norm_out"]["linear"], F.silu(temb)).chunk(2, -1)
    x = layer_norm(x) * (1.0 + scale[:, None]) + shift[:, None]
    return lin(p["proj_out"], x)
