"""Plain HiDream-I1 in float32 over int8 linears, and its seeded weights:
the reference the benchmark holds the served HiDream neural edit against.

The transformer follows the published equations (diffusers'
``transformer_hidream_image.py``) in the published sequence order: [img ;
txt] with the Llama stream of the block appended after the text, the
LoongX condition tokens riding the image stream (their own modulation at
timestep 0, every token seeing every token).  The sparse-expert layer
routes in float32 with its own top-2 (the larger first, ties to the lower
index), weights not renormalised, and adds a shared expert on every token;
each expert is computed on the rows routed to it.

A linear widens its int8 codes when it runs (never a float32 copy of the
tree: 17 B parameters would not fit), and in W8A8 quantizes its float32
input per (row, group) as `flux.quantize_groups` does.  The group of a
K-wide input: the dense products take the largest of 3072, 2048, 2560,
1280 that divides K, else K (2560 at K 2560, 2048 at 2048 and 4096, 256
and 64 whole); the SwiGLU products take the largest multiple of 128 up to
2560 that divides K, else K (2560, 2304 at 6912, 1792 at 3584).

Nothing here imports the measured package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.core import weights
from perfbench.reference import brain, vae
from perfbench.reference.edit import image_ids
from perfbench.reference.flux import (
    QMAX, attention, integer_products, layer_norm, quantize_groups,
    rope_tables, timestep_embedding,
)
from perfbench.reference.layout import Leaf

Tree = Dict[str, Any]
LN_EPS = 1e-6
QK_EPS = 1e-5
SWIGLU_MULTIPLE = 256
TIME_CHANNELS = 256


# ---------------------------------------------------------------------------
# Layout and weights
# ---------------------------------------------------------------------------


def swiglu_width(dim: int, multiple_of: int = SWIGLU_MULTIPLE) -> int:
    h = int(2 * dim / 3)
    return multiple_of * ((h + multiple_of - 1) // multiple_of)


def dims(t: Dict[str, Any]) -> Dict[str, int]:
    """The derived widths of the published transformer config ``t``."""
    d = t["num_attention_heads"] * t["attention_head_dim"]
    mult = t.get("ffn_multiple_of", SWIGLU_MULTIPLE)
    return {"d": d, "c_in": t["patch_size"] ** 2 * t["in_channels"],
            "ffn": swiglu_width(4 * d, mult),
            "shared": swiglu_width(2 * d, mult),
            "streams": t["num_layers"] + t["num_single_layers"],
            "experts": t["num_routed_experts"]}


def _q(k: int, n: int, nb=(), bias: bool = True) -> Tree:
    out = {"kernel_q": Leaf(nb + (k, n), "int8", "codes", k),
           "kernel_scale": Leaf(nb + (1, n), "float32", "qscale", k)}
    if bias:
        out["bias"] = Leaf(nb + (n,), "bfloat16", "bias", k)
    return out


def _swiglu(d: int, f: int, nb) -> Tree:
    return {"w1": _q(d, f, nb, False), "w3": _q(d, f, nb, False),
            "w2": _q(f, d, nb, False)}


def layout(t: Dict[str, Any]) -> Tree:
    """The int8 HiDream tree of the published config ``t``, unfused: every
    linear apart, block stacks with a leading [NB] axis, the routed experts
    [NB, E, ...] (the program's `init_hidream_params` key names)."""
    w = dims(t)
    d, e = w["d"], w["experts"]
    nd, ns = (t["num_layers"],), (t["num_single_layers"],)

    def attn(nb, dual):
        p: Tree = {}
        for sfx in ("", "_t") if dual else ("",):
            for x in ("q", "k", "v", "out"):
                p[f"to_{x}{sfx}"] = _q(d, d, nb)
            for x in ("q", "k"):
                p[f"{x}_norm{sfx}"] = {"weight": Leaf(nb + (d,), "bfloat16",
                                                      "norm_weight")}
        return p

    def moe(nb):
        return {"gate": {"weight": Leaf(nb + (e, d), "float32", "normal")},
                "experts": _swiglu(d, w["ffn"], nb + (e,)),
                "shared": _swiglu(d, w["shared"], nb)}

    return {
        "x_embedder": _q(w["c_in"], d),
        "t_embedder": {"in_layer": _q(TIME_CHANNELS, d),
                       "out_layer": _q(d, d)},
        "p_embedder": {"in_layer": _q(t["text_emb_dim"], d),
                       "out_layer": _q(d, d)},
        "caption_projection": _q(t["caption_channels"][0], d,
                                 (w["streams"] + 1,), False),
        "double_blocks": {"adaLN": {"linear": _q(d, 12 * d, nd)},
                          "attn": attn(nd, True), "moe": moe(nd),
                          "ff_t": _swiglu(d, w["ffn"], nd)},
        "single_blocks": {"adaLN": {"linear": _q(d, 6 * d, ns)},
                          "attn": attn(ns, False), "moe": moe(ns)},
        "final_layer": {"adaLN": {"linear": _q(d, 2 * d)},
                        "linear": _q(d, w["c_in"])},
    }


def make_weights(t: Dict[str, Any], seed: int, device="cuda") -> Tree:
    """The seeded tree of `layout`: int8 codes and per-channel scales as
    `weights.make` draws them, the router W_g ~ N(0, 1) / sqrt(D)."""
    tree = weights.make(layout(t), seed, "hidream", device)
    root = math.sqrt(dims(t)["d"])
    for name in ("double_blocks", "single_blocks"):
        gate = tree[name]["moe"]["gate"]
        gate["weight"] = gate["weight"] / root
    return tree


# ---------------------------------------------------------------------------
# Linears
# ---------------------------------------------------------------------------


def dense_group(k: int) -> int:
    for g in (3072, 2048, 2560, 1280):
        if k % g == 0:
            return g
    return k


def expert_group(k: int) -> int:
    for g in range(min(k, 2560) // 128 * 128, 0, -128):
        if k % g == 0:
            return g
    return k


class Linears:
    """How the int8 linears compute: ``acts`` "float32" (weight-only), "int8"
    (W8A8, the served configuration) or "int4" (the control, one precision
    below)."""

    def __init__(self, acts: str = "int8"):
        if acts not in ("float32", *QMAX):
            raise ValueError(f"unknown activation precision {acts!r}")
        self.acts = acts

    def __call__(self, p: Tree, x: torch.Tensor, idx=(),
                 expert: bool = False) -> torch.Tensor:
        """y = x W (+ b) for float32 x [..., K]; ``idx`` picks one linear of
        a stack (a tuple of leading indices)."""
        codes, scale = p["kernel_q"][idx], p["kernel_scale"][idx]
        bias = p["bias"][idx] if "bias" in p else None
        lead, k = x.shape[:-1], x.shape[-1]
        n = codes.shape[-1]
        x2 = x.reshape(-1, k).float()
        wf = codes.float()
        qmax = QMAX.get(self.acts)
        if qmax is None:
            y = x2 @ (wf * scale.reshape(1, n).float())
        else:
            group = expert_group(k) if expert else dense_group(k)
            xq, xs = quantize_groups(x2, group, k, qmax)
            y = torch.zeros(x2.shape[0], n, dtype=torch.float32,
                            device=x.device)
            with integer_products():
                for g in range(k // group):
                    part = slice(g * group, (g + 1) * group)
                    y += (xq[:, part] @ wf[part]) * xs[:, g:g + 1]
            y = y * scale.reshape(1, n).float()
        if bias is not None:
            y = y + bias.float()
        return y.reshape(*lead, n)


def rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        weight.float()


def swiglu(lin: Linears, p: Tree, x: torch.Tensor, idx=()) -> torch.Tensor:
    h = F.silu(lin(p["w1"], x, idx, True)) * lin(p["w3"], x, idx, True)
    return lin(p["w2"], h, idx, True)


def top2(probs: torch.Tensor, k: int = 2):
    """(indices [N, k], weights [N, k]): the largest first, ties to the
    lower expert index."""
    left, idx, wts = probs.clone(), [], []
    for _ in range(k):
        i = torch.argmax(left, dim=-1)
        idx.append(i)
        wts.append(probs.gather(1, i[:, None])[:, 0])
        left[torch.arange(left.shape[0], device=left.device), i] = -math.inf
    return torch.stack(idx, 1), torch.stack(wts, 1)


def route(p: Tree, x: torch.Tensor, blk: int, top_k: int):
    """The router's (indices, weights) of float32 x [N, D] in block
    ``blk``."""
    logits = x @ p["gate"]["weight"][blk].float().t()
    return top2(torch.softmax(logits, dim=-1), top_k)


def moe(lin: Linears, p: Tree, x: torch.Tensor, blk: int, top_k: int,
        routing=None) -> torch.Tensor:
    """sum_k w_k E_{e_k}(x) + S(x) over float32 x [N, D]; ``routing``
    (indices, weights) in place of the router's own."""
    idx, wts = route(p, x, blk, top_k) if routing is None else routing
    y = swiglu(lin, p["shared"], x, (blk,))
    for e in range(p["experts"]["w1"]["kernel_q"].shape[1]):
        hit = idx == e
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        w = (wts * hit).sum(-1)[rows]
        y[rows] += w[:, None] * swiglu(lin, p["experts"], x[rows], (blk, e))
    return y


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def pack_patches(lat: torch.Tensor, p: int = 2) -> torch.Tensor:
    """[B, h, w, C] -> [B, (h/p)(w/p), p p C], each token laid out (p1, p2,
    C)."""
    b, h, w, c = lat.shape
    x = lat.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpack_patches(tokens: torch.Tensor, h: int, w: int,
                   p: int = 2) -> torch.Tensor:
    b, _, d = tokens.shape
    x = tokens.reshape(b, h // p, w // p, p, p, d // (p * p))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, d // (p * p))


def project_text(p: Tree, lin: Linears, t5: torch.Tensor,
                 llama: torch.Tensor):
    """(T [B, S_t5, D], [L_i]): the 49 caption projections, T5 the last."""
    cp = p["caption_projection"]
    n = llama.shape[1]
    return (lin(cp, t5.float(), (n,)),
            [lin(cp, llama[:, i].float(), (i,)) for i in range(n)])


def _rows(x: torch.Tensor, is_cond: torch.Tensor, main: torch.Tensor,
          cond: torch.Tensor) -> torch.Tensor:
    """Per-row modulation [B, S, D] of a stream whose rows ``is_cond`` [S]
    take the condition tokens' values."""
    return torch.where(is_cond[None, :, None], cond[:, None, :],
                       main[:, None, :])


def hidream_forward(p: Tree, t: Dict[str, Any], lin: Linears, *,
                    img: torch.Tensor, cond: torch.Tensor,
                    text, pooled: torch.Tensor, timestep: torch.Tensor,
                    img_ids: torch.Tensor, cond_ids: torch.Tensor,
                    routings: Optional[List] = None) -> torch.Tensor:
    """The transformer's output [B, S_img, 4 C] (the velocity is its
    negative).  img / cond packed tokens [B, S, 4 C]; ``text`` =
    `project_text`'s (T, [L_i]); pooled [B, 2048]; timestep [B] (scaled by
    1000 here).  ``routings``, a list, receives each expert layer's
    (indices, weights) in order."""
    w = dims(t)
    heads, top_k = t["num_attention_heads"], t["num_activated_experts"]
    b, s_img, s_cond = img.shape[0], img.shape[1], cond.shape[1]
    dev = img.device
    t5_h, llama = text

    def mlp(q, x):
        return lin(q["out_layer"], F.silu(lin(q["in_layer"], x)))

    p_emb = mlp(p["p_embedder"], pooled.float())
    temb = mlp(p["t_embedder"], timestep_embedding(timestep.float() * 1000.0)
               ) + p_emb
    ctemb = mlp(p["t_embedder"], timestep_embedding(
        torch.zeros_like(timestep, dtype=torch.float32))) + p_emb
    img_h = lin(p["x_embedder"], img.float())
    cond_h = lin(p["x_embedder"], cond.float())
    txt = torch.cat([t5_h, llama[-1]], 1)
    s_text = txt.shape[1] + llama[0].shape[1]
    lat_ids = torch.cat([img_ids, cond_ids])
    rope = rope_tables(torch.cat([lat_ids, torch.zeros(s_text, 3, device=dev)]),
                       t["axes_dims_rope"])
    lat_cond = torch.arange(s_img + s_cond, device=dev) >= s_img

    def qkv(a, x, sfx, i):
        q = rms(lin(a[f"to_q{sfx}"], x, (i,)), a[f"q_norm{sfx}"]["weight"][i],
                QK_EPS)
        k = rms(lin(a[f"to_k{sfx}"], x, (i,)), a[f"k_norm{sfx}"]["weight"][i],
                QK_EPS)
        v = lin(a[f"to_v{sfx}"], x, (i,))
        return (y.reshape(b, x.shape[1], heads, -1) for y in (q, k, v))

    def expert(blk_p, x, blk):
        flat = x.reshape(-1, x.shape[-1])
        r = route(blk_p, flat, blk, top_k)
        if routings is not None:
            routings.append(r)
        return moe(lin, blk_p, flat, blk, top_k, r).reshape(x.shape)

    dbl, lat = p["double_blocks"], torch.cat([img_h, cond_h], 1)
    for i in range(t["num_layers"]):
        mi = lin(dbl["adaLN"]["linear"], F.silu(temb), (i,)).chunk(12, -1)
        mc = lin(dbl["adaLN"]["linear"], F.silu(ctemb), (i,)).chunk(12, -1)
        txt_in = torch.cat([txt, llama[i]], 1)
        s_t = txt_in.shape[1]
        a = dbl["attn"]
        n_lat = (layer_norm(lat, LN_EPS) * (1 + _rows(lat, lat_cond, mi[1],
                                                      mc[1]))
                 + _rows(lat, lat_cond, mi[0], mc[0]))
        n_txt = layer_norm(txt_in, LN_EPS) * (1 + mi[7][:, None]) + \
            mi[6][:, None]
        q_l, k_l, v_l = qkv(a, n_lat, "", i)
        q_t, k_t, v_t = qkv(a, n_txt, "_t", i)
        out = attention(torch.cat([q_l, q_t], 1), torch.cat([k_l, k_t], 1),
                        torch.cat([v_l, v_t], 1), rope)
        n_l = lat.shape[1]
        lat = lat + _rows(lat, lat_cond, mi[2], mc[2]) * lin(
            a["to_out"], out[:, :n_l], (i,))
        txt_in = txt_in + mi[8][:, None] * lin(a["to_out_t"], out[:, n_l:],
                                               (i,))
        n2 = (layer_norm(lat, LN_EPS) * (1 + _rows(lat, lat_cond, mi[4],
                                                   mc[4]))
              + _rows(lat, lat_cond, mi[3], mc[3]))
        lat = lat + _rows(lat, lat_cond, mi[5], mc[5]) * expert(dbl["moe"],
                                                                 n2, i)
        n2t = layer_norm(txt_in, LN_EPS) * (1 + mi[10][:, None]) + \
            mi[9][:, None]
        txt_in = txt_in + mi[11][:, None] * swiglu(
            lin, dbl["ff_t"], n2t, (i,)).reshape(n2t.shape)
        txt = txt_in[:, :txt.shape[1]]

    # single blocks over [img ; cond ; txt] (+ the block's Llama stream)
    sgl = p["single_blocks"]
    x = torch.cat([lat, txt], 1)
    n_x = x.shape[1]
    x_cond = torch.arange(n_x + llama[0].shape[1], device=dev)
    x_cond = (x_cond >= s_img) & (x_cond < s_img + s_cond)
    nd = t["num_layers"]
    for j in range(t["num_single_layers"]):
        mx = lin(sgl["adaLN"]["linear"], F.silu(temb), (j,)).chunk(6, -1)
        mc = lin(sgl["adaLN"]["linear"], F.silu(ctemb), (j,)).chunk(6, -1)
        full = torch.cat([x, llama[nd + j]], 1)
        normed = (layer_norm(full, LN_EPS) * (1 + _rows(full, x_cond, mx[1],
                                                        mc[1]))
                  + _rows(full, x_cond, mx[0], mc[0]))
        q, k, v = qkv(sgl["attn"], normed, "", j)
        out = attention(q, k, v, rope)
        full = full + _rows(full, x_cond, mx[2], mc[2]) * lin(
            sgl["attn"]["to_out"], out, (j,))
        n2 = (layer_norm(full, LN_EPS) * (1 + _rows(full, x_cond, mx[4],
                                                    mc[4]))
              + _rows(full, x_cond, mx[3], mc[3]))
        full = full + _rows(full, x_cond, mx[5], mc[5]) * expert(sgl["moe"],
                                                                  n2, j)
        x = full[:, :n_x]
    x = x[:, :s_img]
    shift, scale = lin(p["final_layer"]["adaLN"]["linear"],
                       F.silu(temb)).chunk(2, -1)
    x = layer_norm(x, LN_EPS) * (1 + scale[:, None]) + shift[:, None]
    return lin(p["final_layer"]["linear"], x)


def sigmas(steps: int, shift: float = 6.0) -> np.ndarray:
    """HiDream-I1-Dev's static shift on a plain grid: shift s / (1 + (shift
    - 1) s), s = linspace(1, 0, steps + 1), float32."""
    s = np.linspace(1.0, 0.0, steps + 1)
    return (shift * s / (1.0 + (shift - 1.0) * s)).astype(np.float32)


def neural_edit(w: Tree, cfg: Dict[str, Any], inputs: Dict[str, torch.Tensor],
                steps: int, acts: str = "int8",
                routings: Optional[List] = None) -> torch.Tensor:
    """float32 images [B, H, W, 3] of the edit of ``inputs`` (the condition
    image, the signals, the latents and VAE-sample draws, ``llama`` [B, 48,
    S, 4096] and ``pooled_extra`` [B, 1280]): the brain prompt in the T5
    slot, the brain pooled vector then pooled_extra as the pooled input,
    the Euler step over -out."""
    t, v = cfg["transformer"], cfg["vae"]
    dev = inputs["latents"].device
    image = inputs["image"].float() / 127.5 - 1.0
    prompt, pooled = brain.brain_embeds(w["brain"], inputs)
    pooled = torch.cat([pooled, inputs["pooled_extra"].float()], -1)
    mean, logvar = vae.encode(w["vae"], v, image)
    lat = mean + torch.exp(0.5 * logvar) * inputs["cond_noise"].float()
    p = t["patch_size"]
    cond = pack_patches((lat - v["shift_factor"]) * v["scaling_factor"], p)
    lat_h, lat_w = lat.shape[1], lat.shape[2]
    ids = image_ids(lat_h, lat_w, dev)
    lin = Linears(acts)
    text = project_text(w["hidream"], lin, prompt, inputs["llama"])
    x = inputs["latents"].float()
    b = x.shape[0]
    sig = sigmas(steps)
    for s0, s1 in zip(sig[:-1], sig[1:]):
        out = hidream_forward(
            w["hidream"], t, lin, img=x, cond=cond, text=text, pooled=pooled,
            timestep=torch.full((b,), float(s0), device=dev), img_ids=ids,
            cond_ids=ids, routings=routings)
        x = x + float(np.float32(s1) - np.float32(s0)) * (-out)
    lat = unpack_patches(x, lat_h, lat_w, p) / v["scaling_factor"] + \
        v["shift_factor"]
    return vae.decode(w["vae"], v, lat)

