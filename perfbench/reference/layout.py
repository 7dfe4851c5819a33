"""The parameter trees of the measured models, as shapes: FLUX.1 (int8
linears in the unfused layout), its VAE, the CS3 biosignal encoders and the
DGF fusion.  Nested dicts whose leaves are `Leaf` specs; `perfbench.core.
weights` fills them from a seed, and the reference reads the filled trees by
the same key names.

The layout is the one the measured package takes (the JAX package's tree:
linears ``{kernel [in, out], bias}``, int8 linears ``{kernel_q [in, out],
kernel_scale [1, out], bias}``, block stacks with a leading ``[NB]`` axis,
conv kernels HWIO).  Nothing here imports the measured package.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

Tree = Dict[str, Any]


class Leaf(NamedTuple):
    shape: Tuple[int, ...]
    dtype: str      # "int8" | "bfloat16" | "float32"
    kind: str       # how `weights.fill` draws it
    fan_in: int = 1


def _qlinear(k: int, n: int, nb: Tuple[int, ...] = ()) -> Tree:
    return {"kernel_q": Leaf(nb + (k, n), "int8", "codes", k),
            "kernel_scale": Leaf(nb + (1, n), "float32", "qscale", k),
            "bias": Leaf(nb + (n,), "bfloat16", "bias", k)}


def _linear(k: int, n: int, dtype: str = "bfloat16", bias: bool = True,
            nb: Tuple[int, ...] = ()) -> Tree:
    out = {"kernel": Leaf(nb + (k, n), dtype, "kernel", k)}
    if bias:
        out["bias"] = Leaf(nb + (n,), dtype, "bias", k)
    return out


def _norm(dim: int, dtype: str, bias: bool = True,
          nb: Tuple[int, ...] = ()) -> Tree:
    out = {"weight": Leaf(nb + (dim,), dtype, "norm_weight")}
    if bias:
        out["bias"] = Leaf(nb + (dim,), dtype, "norm_bias")
    return out


def flux_layout(t: Dict[str, Any]) -> Tree:
    """The int8 FLUX tree from the published transformer config ``t``
    (diffusers' key names), q / k / v and proj_out unfused."""
    heads, hd = t["num_attention_heads"], t["attention_head_dim"]
    h, mlp = heads * hd, 4 * heads * hd
    nd, ns = (t["num_layers"],), (t["num_single_layers"],)
    tc = 256

    def attn(nb, dual):
        p = {f"to_{x}": _qlinear(h, h, nb) for x in "qkv"}
        p["norm_q"] = _norm(hd, "bfloat16", False, nb)
        p["norm_k"] = _norm(hd, "bfloat16", False, nb)
        if dual:
            p.update({f"add_{x}_proj": _qlinear(h, h, nb) for x in "qkv"})
            p["norm_added_q"] = _norm(hd, "bfloat16", False, nb)
            p["norm_added_k"] = _norm(hd, "bfloat16", False, nb)
            p["to_out"] = _qlinear(h, h, nb)
            p["to_add_out"] = _qlinear(h, h, nb)
        return p

    tree: Tree = {
        "x_embedder": _qlinear(t["in_channels"], h),
        "context_embedder": _qlinear(t["joint_attention_dim"], h),
        "time_in": {"in_layer": _qlinear(tc, h), "out_layer": _qlinear(h, h)},
        "vector_in": {"in_layer": _qlinear(t["pooled_projection_dim"], h),
                      "out_layer": _qlinear(h, h)},
        "double_blocks": {
            "norm1": {"linear": _qlinear(h, 6 * h, nd)},
            "norm1_context": {"linear": _qlinear(h, 6 * h, nd)},
            "attn": attn(nd, True),
            "ff": {"in": _qlinear(h, mlp, nd), "out": _qlinear(mlp, h, nd)},
            "ff_context": {"in": _qlinear(h, mlp, nd),
                           "out": _qlinear(mlp, h, nd)},
        },
        "single_blocks": {
            "norm": {"linear": _qlinear(h, 3 * h, ns)},
            "attn": attn(ns, False),
            "proj_mlp": _qlinear(h, mlp, ns),
            "proj_out": _qlinear(h + mlp, h, ns),
        },
        "norm_out": {"linear": _qlinear(h, 2 * h)},
        "proj_out": _qlinear(h, t["in_channels"]),
    }
    if t["guidance_embeds"]:
        tree["guidance_in"] = {"in_layer": _qlinear(tc, h),
                               "out_layer": _qlinear(h, h)}
    return tree


def _conv(kh: int, cin: int, cout: int) -> Tree:
    fan = kh * kh * cin
    return {"kernel": Leaf((kh, kh, cin, cout), "bfloat16", "kernel", fan),
            "bias": Leaf((cout,), "bfloat16", "bias", fan)}


def _resnet(cin: int, cout: int) -> Tree:
    p = {"norm1": _norm(cin, "bfloat16"), "conv1": _conv(3, cin, cout),
         "norm2": _norm(cout, "bfloat16"), "conv2": _conv(3, cout, cout)}
    if cin != cout:
        p["shortcut"] = _conv(1, cin, cout)
    return p


def _vae_attn(c: int) -> Tree:
    p = {"norm": _norm(c, "bfloat16")}
    for name in ("to_q", "to_k", "to_v", "to_out"):
        p[name] = _conv(1, c, c)
    return p


def vae_layout(v: Dict[str, Any]) -> Tree:
    """The AutoencoderKL tree from the published VAE config ``v``."""
    ch, lpb = v["block_out_channels"], v["layers_per_block"]
    enc: Tree = {"conv_in": _conv(3, v["in_channels"], ch[0])}
    cin = ch[0]
    for i, cout in enumerate(ch):
        block = {f"resnet_{j}": _resnet(cin if j == 0 else cout, cout)
                 for j in range(lpb)}
        if i < len(ch) - 1:
            block["downsample"] = _conv(3, cout, cout)
        enc[f"down_{i}"] = block
        cin = cout
    enc["mid"] = {"resnet_0": _resnet(cin, cin), "attn": _vae_attn(cin),
                  "resnet_1": _resnet(cin, cin)}
    enc["norm_out"] = _norm(cin, "bfloat16")
    enc["conv_out"] = _conv(3, cin, 2 * v["latent_channels"])
    rch = list(reversed(ch))
    dec: Tree = {"conv_in": _conv(3, v["latent_channels"], rch[0]),
                 "mid": {"resnet_0": _resnet(rch[0], rch[0]),
                         "attn": _vae_attn(rch[0]),
                         "resnet_1": _resnet(rch[0], rch[0])}}
    cin = rch[0]
    for i, cout in enumerate(rch):
        block = {f"resnet_{j}": _resnet(cin if j == 0 else cout, cout)
                 for j in range(lpb + 1)}
        if i < len(rch) - 1:
            block["upsample"] = _conv(3, cout, cout)
        dec[f"up_{i}"] = block
        cin = cout
    dec["norm_out"] = _norm(cin, "bfloat16")
    dec["conv_out"] = _conv(3, cin, v["in_channels"])
    return {"encoder": enc, "decoder": dec}


def _s4_stack(d_in: int, d_model: int, d_out: int, n_state: int) -> Tree:
    n = n_state // 2
    block = {"s4": {"log_A_real": Leaf((d_model, n), "float32", "s4_log_a"),
                    "A_imag": Leaf((d_model, n), "float32", "s4_a_imag"),
                    "C": Leaf((d_model, n, 2), "float32", "normal"),
                    "log_dt": Leaf((d_model,), "float32", "s4_log_dt"),
                    "D": Leaf((d_model,), "float32", "norm_weight")},
             "out": _linear(d_model, 2 * d_model, "float32"),
             "norm": _norm(d_model, "float32")}
    return {"encoder": _linear(d_in, d_model, "float32"),
            "blocks": [block, dict(block)],
            "decoder": _linear(d_model, d_out, "float32")}


def _mlp_ln(dims) -> Tree:
    p: Tree = {}
    for i in range(len(dims) - 1):
        p[f"linear_{i}"] = _linear(dims[i], dims[i + 1])
        p[f"ln_{i}"] = _norm(dims[i + 1], "bfloat16")
    return p


def brain_layout() -> Tree:
    """The CS3 encoders (EEG, PPG, fNIRS, motion) and the DGF fusion; their
    widths are fixed by the LoongX design (PAPER.md, CS3 and DGF)."""
    def duan(c):
        return {"gate_in": _linear(c, 128), "gate_out": _linear(128, c),
                "mlp_in": _linear(c, 128), "mlp_out": _linear(128, 2 * c)}

    return {
        "encoders": {
            "eeg": {"s4_wide": _s4_stack(4, 64, 64, 64),
                    "s4_narrow": _s4_stack(4, 4, 4, 4),
                    "proj": _mlp_ln([4 * 4096, 2048, 4096]),
                    "token_proj": _linear(8, 4096)},
            "ppg": {"s4": _s4_stack(4, 4, 4, 4),
                    "proj": _mlp_ln([4 * 16 + 448 * 4, 1024, 4096]),
                    "token_proj": _linear(8, 4096)},
            "fnirs": {"s4": _s4_stack(6, 6, 6, 6),
                      "proj": _mlp_ln([6 * 32 + 832 * 6, 1024, 768])},
            "motion": {"s4": _s4_stack(6, 6, 6, 6),
                       "proj": _mlp_ln([6 * 6 + 220 * 6, 512, 768])},
        },
        "dgf": {
            "duan_signal": duan(512), "duan_pooled_sig": duan(1),
            "duan_prompt": duan(512), "duan_pooled": duan(1),
            "fusion_signal": _linear(1024, 512),
            "fusion_pooled_sig": _linear(1536, 768),
            "fusion_prompt": _linear(1024, 512),
            "fusion_pooled": _linear(1536, 768),
        },
    }


def get_path(tree: Tree, path: str) -> Tree:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def lora_layout(flux: Tree, rank: int, targets) -> Dict[str, Tree]:
    """{target path: {lora_a [.., in, r], lora_b [.., r, out]}} for every
    target path (stacked-block axes implicit) of the FLUX layout ``flux``:
    A ~ N(0, 1) / r, B = 0 (the peft "gaussian" initialisation)."""
    out = {}
    for path in targets:
        *nb, k, n = get_path(flux, path)["kernel_q"].shape
        nb = tuple(nb)
        out[path] = {"lora_a": Leaf(nb + (k, rank), "bfloat16", "lora_a",
                                    rank),
                     "lora_b": Leaf(nb + (rank, n), "bfloat16", "zeros")}
    return out
