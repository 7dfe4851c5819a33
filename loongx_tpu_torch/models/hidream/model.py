"""HiDream-I1's diffusion transformer (HiDream-ai/HiDream-I1, diffusers'
``transformer_hidream_image.py``) on the port's neural-edit path: a
17 B-parameter DiT whose image-stream feed-forward is a sparse mixture of
SwiGLU experts (`ops.moe`), with the LoongX condition-token stream.

Layer equations (D = heads x head_dim, LN the layer norm without affine,
eps 1e-6; c = silu(temb)):

  * x_embedder: Linear(4 C -> D) on 2 x 2 latent patches laid out (p1, p2,
    C) (`pack_patches`); temb = MLP_t(sinusoid(1000 t)) + MLP_p(pooled),
    no guidance embedding;
  * text: T = P_48(t5) and L_i = P_i(llama_i), i < 48, 49 bias-free
    projections (`project_text`, once a request); txt0 = [T ; L_47];
  * double block i (16): txt_in = [txt ; L_i]; Linear(c) gives 12 D chunked
    shift, scale, gate (msa), shift, scale, gate (mlp) for the image
    stream, then the same for the text stream; q and k RMS-normed over all
    D columns (eps 1e-5, a weight each); one joint attention (RoPE on all
    128 dims, text ids 0); img += gate * MoE(LN(img)(1 + scale) + shift),
    txt_in += gate * SwiGLU(...); txt = txt_in without L_i's rows;
  * single block j (32, stream 16 + j): x_in = [x ; L_i]; Linear(c) gives
    6 D; self-attention, then the MoE over every token of x_in; L_i's rows
    dropped after it;
  * output: shift, scale = Linear(c) (shift first); Linear(LN(img)(1 +
    scale) + shift) -> 4 C.  The published pipeline feeds -out to its
    Euler step (`sampling.generate.denoise` negates it).

The condition tokens (the source image's latents) ride the image stream at
the condition timestep c_t with their own modulation (FLUX's
`_mod_pair` / `_seg_affine`), so in double blocks they go through the MoE
too.  The port orders a sequence [txt ; L_i ; img ; cond] in double blocks
and [L_i ; txt ; img ; cond] in single ones (the published order is [img ;
txt]; attention is permutation-equivariant when every token keeps its
RoPE ids, and text ids are 0).

Params: `init_hidream_params` builds the published unfused tree (float
``kernel`` leaves, block stacks with a leading [NB] axis, the experts
[NB, E, ...]); ``ops.quant`` quantizes it; `serving_layout` turns the int8
tree into the serving layout: each stream's q / k / v fused into one
[D, 3 D] product, each SwiGLU's W1 and W3 fused into one [D, 2 F] weight
interleaved per 128-column tile (`ops.moe.interleave_swiglu`), the shared
expert and the text SwiGLU as one-group stacks, every flat linear a stack
of one (so every dense product takes the stacked kernels' activation
group: 2560 at K 2560, 2048 at K 2048 and 4096).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from loongx_tpu_torch.models.flux.model import (
    _attention, _block_view, _mod_pair, _seg_affine, gate_res_linear, linear,
    timestep_embedding,
)
from loongx_tpu_torch.ops import moe
from loongx_tpu_torch.ops.nn import (
    Params, init_linear, layer_norm, rms_norm, silu, stack_trees,
)
from loongx_tpu_torch.ops.rope import rope_embed


def _swiglu_width(dim: int, multiple_of: int) -> int:
    """FeedForwardSwiGLU's hidden width: int(2 dim / 3) rounded up."""
    h = int(2 * dim / 3)
    return multiple_of * ((h + multiple_of - 1) // multiple_of)


@dataclasses.dataclass(frozen=True)
class HiDreamConfig:
    patch_size: int = 2
    latent_channels: int = 16
    num_heads: int = 20
    head_dim: int = 128
    num_double_blocks: int = 16
    num_single_blocks: int = 32
    caption_dim: int = 4096     # T5-v1.1-XXL and Llama-3.1-8B hidden width
    pooled_dim: int = 2048      # CLIP-L pooled 768 || CLIP-G pooled 1280
    num_experts: int = 4
    top_k: int = 2
    axes_dims: Tuple[int, ...] = (64, 32, 32)
    theta: float = 10000.0
    ffn_multiple_of: int = 256
    time_embed_channels: int = 256
    qk_eps: float = 1e-5
    guidance_embeds: bool = False  # HiDream-I1-Dev is guidance-distilled

    @property
    def hidden(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def in_channels(self) -> int:
        """Width of a packed latent token: patch^2 x latent channels."""
        return self.patch_size ** 2 * self.latent_channels

    @property
    def llama_streams(self) -> int:
        return self.num_double_blocks + self.num_single_blocks

    @property
    def ffn_dim(self) -> int:
        """The routed experts' and the text stream's SwiGLU width."""
        return _swiglu_width(4 * self.hidden, self.ffn_multiple_of)

    @property
    def shared_dim(self) -> int:
        """The shared expert's SwiGLU width."""
        return _swiglu_width(2 * self.hidden, self.ffn_multiple_of)

    @staticmethod
    def hidream_i1() -> "HiDreamConfig":
        """HiDream-I1 (-Full, -Dev and -Fast share it): D 2560, 16 + 32
        blocks, 4 routed experts top-2, FFN 6912, shared 3584."""
        return HiDreamConfig()

    @staticmethod
    def tiny(caption_dim: int = 32, pooled_dim: int = 48,
             latent_channels: int = 4) -> "HiDreamConfig":
        """Same topology at tiny widths (tests): D 64, 2 + 2 blocks, 4
        experts top-2, FFN 192, shared 128."""
        return HiDreamConfig(
            latent_channels=latent_channels, num_heads=2, head_dim=32,
            num_double_blocks=2, num_single_blocks=2, caption_dim=caption_dim,
            pooled_dim=pooled_dim, axes_dims=(8, 12, 12), ffn_multiple_of=64)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _swiglu_params(d: int, f: int, kw) -> Params:
    return {"w1": init_linear(d, f, bias=False, **kw),
            "w3": init_linear(d, f, bias=False, **kw),
            "w2": init_linear(f, d, bias=False, **kw)}


def _moe_params(cfg: HiDreamConfig, kw) -> Params:
    """The router W_g [E, D] ~ N(0, 1) / sqrt(D), the routed experts
    stacked [E, ...], the shared expert."""
    d = cfg.hidden
    gate = torch.empty(cfg.num_experts, d, dtype=torch.float32,
                       device=kw["device"])
    if kw["device"] != "meta":
        gate = gate.normal_(generator=kw["generator"]) / math.sqrt(d)
    return {"gate": {"weight": gate},
            "experts": stack_trees([_swiglu_params(d, cfg.ffn_dim, kw)
                                    for _ in range(cfg.num_experts)]),
            "shared": _swiglu_params(d, cfg.shared_dim, kw)}


def _attn_params(cfg: HiDreamConfig, dual: bool, kw) -> Params:
    d = cfg.hidden
    norm = dict(dtype=kw["dtype"], device=kw["device"])
    p: Params = {}
    for sfx in ("", "_t") if dual else ("",):
        p.update({f"to_{x}{sfx}": init_linear(d, d, **kw) for x in "qkvo"})
        p[f"to_out{sfx}"] = p.pop(f"to_o{sfx}")
        p[f"q_norm{sfx}"] = {"weight": torch.ones(d, **norm)}
        p[f"k_norm{sfx}"] = {"weight": torch.ones(d, **norm)}
    return p


def init_hidream_params(cfg: HiDreamConfig, *, generator=None,
                        dtype=torch.bfloat16, device="cuda") -> Params:
    """The published tree, unfused (module docstring); on the ``meta``
    device only shapes exist."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    d, tc = cfg.hidden, cfg.time_embed_channels

    def double():
        return {"adaLN": {"linear": init_linear(d, 12 * d, **kw)},
                "attn": _attn_params(cfg, True, kw),
                "moe": _moe_params(cfg, kw),
                "ff_t": _swiglu_params(d, cfg.ffn_dim, kw)}

    def single():
        return {"adaLN": {"linear": init_linear(d, 6 * d, **kw)},
                "attn": _attn_params(cfg, False, kw),
                "moe": _moe_params(cfg, kw)}

    return {
        "x_embedder": init_linear(cfg.in_channels, d, **kw),
        "t_embedder": {"in_layer": init_linear(tc, d, **kw),
                       "out_layer": init_linear(d, d, **kw)},
        "p_embedder": {"in_layer": init_linear(cfg.pooled_dim, d, **kw),
                       "out_layer": init_linear(d, d, **kw)},
        "caption_projection": stack_trees(
            [init_linear(cfg.caption_dim, d, bias=False, **kw)
             for _ in range(cfg.llama_streams + 1)]),
        "double_blocks": stack_trees([double()
                                      for _ in range(cfg.num_double_blocks)]),
        "single_blocks": stack_trees([single()
                                      for _ in range(cfg.num_single_blocks)]),
        "final_layer": {"adaLN": {"linear": init_linear(d, 2 * d, **kw)},
                        "linear": init_linear(d, cfg.in_channels, **kw)},
    }


def _stack_of_one(p: Params) -> Params:
    return {k: v[None] for k, v in p.items()}


def _fuse_qkv(attn: Params, sfx: str) -> Params:
    parts = [attn.pop(f"to_{x}{sfx}") for x in "qkv"]
    return {key: torch.cat([q[key] for q in parts], dim=-1)
            for key in ("kernel_q", "kernel_scale", "bias")}


def _swiglu_serving(p: Params, one_group: bool) -> Params:
    w1, w3, w2 = p.pop("w1"), p.pop("w3"), p.pop("w2")
    out = {"w13_q": moe.interleave_swiglu(w1["kernel_q"], w3["kernel_q"]),
           "w13_scale": moe.interleave_swiglu(w1["kernel_scale"],
                                              w3["kernel_scale"]),
           "w2_q": w2["kernel_q"], "w2_scale": w2["kernel_scale"]}
    del w1, w3
    if one_group:  # [NB, ...] -> [NB, 1, ...]
        out = {k: v.unsqueeze(1) for k, v in out.items()}
    return {k: v.contiguous() for k, v in out.items()}


def serving_layout(params: Params) -> Params:
    """The int8 published tree -> the serving layout (module docstring).
    Consumes ``params``: each transformed subtree's originals are dropped
    as its replacement is made."""
    out: Params = {}
    for name in ("x_embedder", "final_layer", "t_embedder", "p_embedder"):
        tree = params.pop(name)
        if "kernel_q" in tree:
            out[name] = _stack_of_one(tree)
        else:
            out[name] = {k: (_stack_of_one(v["linear"]) if k == "adaLN"
                             else _stack_of_one(v)) for k, v in tree.items()}
            if "adaLN" in out[name]:
                out[name]["adaLN"] = {"linear": out[name]["adaLN"]}
    out["caption_projection"] = params.pop("caption_projection")
    for name, dual in (("double_blocks", True), ("single_blocks", False)):
        blk = params.pop(name)
        attn = blk["attn"]
        attn["to_qkv"] = _fuse_qkv(attn, "")
        if dual:
            attn["to_qkv_t"] = _fuse_qkv(attn, "_t")
        m = blk["moe"]
        blk["moe"] = {"gate_w": m["gate"]["weight"].float().contiguous(),
                      "experts": _swiglu_serving(m["experts"], False),
                      "shared": _swiglu_serving(m["shared"], True)}
        if dual:
            blk["ff_t"] = _swiglu_serving(blk["ff_t"], True)
        out[name] = blk
    return out


# ---------------------------------------------------------------------------
# Patches and text
# ---------------------------------------------------------------------------


def pack_patches(latents: torch.Tensor, p: int = 2) -> torch.Tensor:
    """[B, H, W, C] latent grid -> [B, (H/p)(W/p), p p C] tokens laid out
    (p1, p2, C), HiDream's patch order."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpack_patches(tokens: torch.Tensor, h: int, w: int,
                   p: int = 2) -> torch.Tensor:
    """Inverse of `pack_patches`: [B, S, p p C] -> [B, h, w, C]."""
    b, _, d = tokens.shape
    c = d // (p * p)
    x = tokens.reshape(b, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _flat(p: Params, blk: int = 0) -> Params:
    """A stacked int8 linear's block ``blk`` as `linear` takes it."""
    return {**p, "_blk": blk}


def project_text(params: Params, cfg: HiDreamConfig, t5: torch.Tensor,
                 llama: torch.Tensor, w8a8: bool = False
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(T [B, S_t5, D], [L_i [B, S_llama, D] for i < 48]): the caption
    projections of the T5 states and of the 48 Llama layers' states
    (llama [B, 48, S_llama, caption_dim]), once a request."""
    cp, dtype = params["caption_projection"], t5.dtype
    n = cfg.llama_streams
    t = linear(_flat(cp, n), t5, use_lora=False, w8a8=w8a8)
    ls = [linear(_flat(cp, i), llama[:, i].to(dtype), use_lora=False,
                 w8a8=w8a8) for i in range(n)]
    return t, ls


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _qkv(attn: Params, x: torch.Tensor, sfx: str, cfg: HiDreamConfig,
         w8a8: bool):
    """q, k, v [B, S, H, Dh]: one fused product (bias in its epilogue), q
    and k RMS-normed over all D columns."""
    b, s, _ = x.shape
    q, k, v = linear(attn[f"to_qkv{sfx}"], x, use_lora=False,
                     w8a8=w8a8).chunk(3, dim=-1)
    q = rms_norm(q, attn[f"q_norm{sfx}"]["weight"], cfg.qk_eps)
    k = rms_norm(k, attn[f"k_norm{sfx}"]["weight"], cfg.qk_eps)
    shape = (b, s, cfg.num_heads, cfg.head_dim)
    # the flash kernels take whole planes: v out of the [M, 3D] product
    return q.reshape(shape), k.reshape(shape), v.reshape(shape).contiguous()


def _gates(main: torch.Tensor, cond: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, 2, D] float32 gate rows (main, cond) of the expert combine."""
    return torch.stack([main, main if cond is None else cond], 1).float()


def double_block(blk: Params, cfg: HiDreamConfig, index: int, img, cond, txt,
                 llama_i, temb, cond_temb, rope, flags, c_factor, w8a8,
                 int8_attn):
    """One dual-stream block: the image stream [img ; cond] and the text
    stream [txt ; L_i] -> (img, cond, txt), L_i's rows dropped."""
    use_cond = cond is not None
    s_img, s_txt = img.shape[1], txt.shape[1]
    s_cond = cond.shape[1] if use_cond else 0
    lat = torch.cat([img, cond], dim=1) if use_cond else img
    txt_in = torch.cat([txt, llama_i], dim=1)
    mi, mc = _mod_pair(blk["adaLN"], temb, cond_temb if use_cond else None,
                       False, 12, w8a8)
    if not use_cond:
        mc = [None] * 12
    attn = blk["attn"]

    def seg_mod(x, shift, scale):
        return _seg_affine(layer_norm(x), s_img, 1.0 + mi[scale], mi[shift],
                           None if mc[0] is None else 1.0 + mc[scale],
                           mc[shift])

    def txt_mod(x, shift, scale):
        return layer_norm(x) * (1.0 + mi[scale][:, None]) + mi[shift][:, None]

    q_l, k_l, v_l = _qkv(attn, seg_mod(lat, 0, 1), "", cfg, w8a8)
    q_t, k_t, v_t = _qkv(attn, txt_mod(txt_in, 6, 7), "_t", cfg, w8a8)
    s_t = txt_in.shape[1]
    out = _attention(torch.cat([q_t, q_l], 1), torch.cat([k_t, k_l], 1),
                     torch.cat([v_t, v_l], 1), s_cond, flags, c_factor, rope,
                     int8_attn)
    lat = gate_res_linear(attn["to_out"], out[:, s_t:], lat, mi[2], mc[2], s_img, False, None,
                          w8a8)
    txt_in = txt_in + mi[8][:, None] * linear(
        attn["to_out_t"], out[:, :s_t], use_lora=False, w8a8=w8a8)

    b, s_lat, d = lat.shape
    lat = moe.expert_layer(
        seg_mod(lat, 3, 4).reshape(-1, d), blk["moe"], lat.reshape(-1, d),
        _gates(mi[5], mc[5]), s_lat, s_img, cfg.top_k, index,
        cfg.llama_streams, w8a8).reshape(b, s_lat, d)
    txt_in = moe.swiglu_layer(
        txt_mod(txt_in, 9, 10).reshape(-1, d), blk["ff_t"],
        txt_in.reshape(-1, d), _gates(mi[11], None), s_t, s_t,
        w8a8).reshape(b, s_t, d)
    return (lat[:, :s_img], lat[:, s_img:] if use_cond else None,
            txt_in[:, :s_txt])


def single_block(blk: Params, cfg: HiDreamConfig, index: int, x, cond,
                 llama_i, temb, cond_temb, rope, flags, c_factor, w8a8,
                 int8_attn):
    """One single-stream block over [L_i ; x ; cond] (x = [txt ; img]) ->
    (x, cond), L_i's rows dropped."""
    use_cond = cond is not None
    s_l, s_x = llama_i.shape[1], x.shape[1]
    s_cond = cond.shape[1] if use_cond else 0
    parts = [llama_i, x] + ([cond] if use_cond else [])
    full = torch.cat(parts, dim=1)
    boundary = s_l + s_x
    mx, mc = _mod_pair(blk["adaLN"], temb, cond_temb if use_cond else None,
                       False, 6, w8a8)
    if not use_cond:
        mc = [None] * 6

    def seg_mod(t, shift, scale):
        return _seg_affine(layer_norm(t), boundary, 1.0 + mx[scale],
                           mx[shift], None if mc[0] is None
                           else 1.0 + mc[scale], mc[shift])

    attn = blk["attn"]
    q, k, v = _qkv(attn, seg_mod(full, 0, 1), "", cfg, w8a8)
    out = _attention(q, k, v, s_cond, flags, c_factor, rope, int8_attn)
    full = gate_res_linear(attn["to_out"], out, full, mx[2], mc[2], boundary,
                           False, None, w8a8)
    b, s, d = full.shape
    full = moe.expert_layer(
        seg_mod(full, 3, 4).reshape(-1, d), blk["moe"], full.reshape(-1, d),
        _gates(mx[5], mc[5]), s, boundary, cfg.top_k, index,
        cfg.llama_streams, w8a8).reshape(b, s, d)
    return (full[:, s_l:boundary],
            full[:, boundary:] if use_cond else None)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed(params: Params, cfg: HiDreamConfig, t1000: torch.Tensor,
           pooled: torch.Tensor, w8a8: bool) -> torch.Tensor:
    """MLP_t(sinusoid(t1000)) [N, D] + MLP_p(pooled) (pooled [B, P], N a
    multiple of B: the timestep rows of each batch, in blocks of B)."""
    dtype = pooled.dtype

    def mlp(p, x):
        h = linear(_flat(p["in_layer"]), x, use_lora=False, w8a8=w8a8)
        return linear(_flat(p["out_layer"]), silu(h), use_lora=False,
                      w8a8=w8a8)

    t_emb = mlp(params["t_embedder"],
                timestep_embedding(t1000, cfg.time_embed_channels).to(dtype))
    p_emb = mlp(params["p_embedder"], pooled)
    return t_emb + p_emb.repeat(t_emb.shape[0] // p_emb.shape[0], 1)


def hidream_forward(params: Params, cfg: HiDreamConfig, *, img: torch.Tensor,
                    txt: torch.Tensor, pooled: torch.Tensor,
                    timestep: torch.Tensor, img_ids: torch.Tensor,
                    txt_ids: Optional[torch.Tensor] = None,
                    text_streams: Optional[torch.Tensor] = None,
                    guidance: Optional[torch.Tensor] = None,
                    cond: Optional[torch.Tensor] = None,
                    cond_ids: Optional[torch.Tensor] = None,
                    flags: Optional[Dict[str, Any]] = None, c_t: float = 0.0,
                    c_factor: Optional[float] = None, w8a8: bool = False,
                    int8_attn: bool = False,
                    projected: Optional[Tuple[torch.Tensor,
                                              Sequence[torch.Tensor]]] = None
                    ) -> torch.Tensor:
    """The conditioned HiDream-I1 forward -> the transformer's output [B,
    S_img, in_channels] (the pipeline's velocity is its negative).

    img / cond [B, S, in_channels] tokens packed by `pack_patches`; txt
    [B, S_t5, caption_dim] the T5 slot; text_streams [B, 48, S_llama,
    caption_dim] the Llama layers' states; ``projected`` = `project_text`'s
    output in their place (a request projects them once); pooled [B,
    pooled_dim]; timestep [B] (scaled by 1000 here); img_ids / cond_ids
    [S, 3] (text ids are 0: ``txt_ids`` is not read).  HiDream-I1-Dev has
    no guidance embedding (``guidance`` is not read).  The rest as in
    `flux_forward`."""
    del txt_ids, guidance
    flags = flags or {}
    if w8a8:
        moe.kmajor_stacks(params)  # the grouped GEMM reads them K-major
    use_cond = cond is not None
    wdt = img.dtype
    pooled = pooled.to(wdt)
    if projected is None:
        projected = project_text(params, cfg, txt.to(wdt), text_streams, w8a8)
    t5_h, llama = projected
    txt_h = torch.cat([t5_h, llama[-1]], dim=1).to(wdt)
    img_h = linear(_flat(params["x_embedder"]), img, use_lora=False,
                   w8a8=w8a8)
    cond_h = (linear(_flat(params["x_embedder"]), cond.to(wdt),
                     use_lora=False, w8a8=w8a8) if use_cond else None)

    b = img.shape[0]
    t1000 = timestep.float() * 1000.0
    if use_cond:
        both = _embed(params, cfg, torch.cat(
            [t1000, torch.full_like(t1000, c_t * 1000.0)]), pooled, w8a8)
        temb, cond_temb = both[:b], both[b:]
    else:
        temb, cond_temb = _embed(params, cfg, t1000, pooled, w8a8), None

    s_text = txt_h.shape[1] + llama[0].shape[1]
    ids = [torch.zeros(s_text, 3, dtype=torch.float32, device=img.device),
           img_ids] + ([cond_ids] if use_cond else [])
    rope = rope_embed(torch.cat(ids, dim=0), cfg.axes_dims, cfg.theta)

    nd = cfg.num_double_blocks
    for i in range(nd):
        img_h, cond_h, txt_h = double_block(
            _block_view(params["double_blocks"], i), cfg, i, img_h, cond_h,
            txt_h, llama[i].to(wdt), temb, cond_temb, rope, flags, c_factor,
            w8a8, int8_attn)
    x = torch.cat([txt_h, img_h], dim=1)
    s_txt = txt_h.shape[1]
    for j in range(cfg.num_single_blocks):
        x, cond_h = single_block(
            _block_view(params["single_blocks"], j), cfg, nd + j, x, cond_h,
            llama[nd + j].to(wdt), temb, cond_temb, rope, flags, c_factor,
            w8a8, int8_attn)
    x = x[:, s_txt:]
    fin = params["final_layer"]
    mod = linear(_flat(fin["adaLN"]["linear"]), silu(temb), use_lora=False,
                 w8a8=w8a8)
    shift, scale = mod.chunk(2, dim=-1)
    x = layer_norm(x) * (1.0 + scale[:, None, :]) + shift[:, None, :]
    return linear(_flat(fin["linear"]), x, use_lora=False, w8a8=w8a8)
