"""Operations and bytes of the served HiDream-I1 edit, from the
configuration's shapes (`perfbench.core.flops`'s conventions: a product
reads its input once and writes its output once, bf16 activations, int8
weights, float32 per-channel scales).

Kinds: ``"linear"`` for the dense int8 products (attention projections,
adaLN, embedders, caption projections, output), ``"expert"`` for every
SwiGLU product (the routed experts, the shared expert, the text stream's
dense SwiGLU), ``"attention"`` as in `flops.attention`.  A routed expert
layer counts top-k rows a token; each expert's weight is read once a layer,
so a layer's bytes and operations do not depend on how tokens are routed.
The 49 caption projections do not depend on the step: they count once a
request (`caption_ops`), whether or not the program hoists them.
"""

from __future__ import annotations

from typing import Any, Dict, List

from perfbench.core.flops import Op, attention, linear
from perfbench.reference.hidream import dims


def expert(name: str, rows: int, k: int, n: int, groups: int,
           out: int) -> Op:
    """``groups`` weights [K, N] over ``rows`` input rows in all, each row's
    output ``out`` wide (N / 2 after a SwiGLU epilogue)."""
    return Op(name, "expert", 2.0 * rows * k * n,
              rows * k * 2 + groups * (k * n + n * 4) + rows * out * 2,
              "int8")


def _swiglu(name: str, rows: int, d: int, f: int, groups: int) -> List[Op]:
    return [expert(f"{name}.w13", rows, d, 2 * f, groups, f),
            expert(f"{name}.w2", rows, f, d, groups, d)]


def _moe(name: str, tokens: int, w: Dict[str, int], top_k: int) -> List[Op]:
    d = w["d"]
    return (_swiglu(f"{name}.routed", top_k * tokens, d, w["ffn"],
                    w["experts"])
            + _swiglu(f"{name}.shared", tokens, d, w["shared"], 1))


def serve_forward(t: Dict[str, Any], b: int, s_txt: int, s_llama: int,
                  s_img: int, s_cond: int) -> List[Op]:
    """One W8A8 forward at batch ``b``: image and condition tokens, the
    text stream's T5 and last-Llama rows (``s_txt``) and a block's Llama
    rows (``s_llama``)."""
    w = dims(t)
    d, heads, hd = w["d"], t["num_attention_heads"], t["attention_head_dim"]
    top_k = t["num_activated_experts"]
    lat, text = b * (s_img + s_cond), b * (s_txt + s_llama)
    full = lat + text
    s = s_img + s_cond + s_txt + s_llama
    ops = [linear("x_embedder.img", b * s_img, w["c_in"], d, "int8"),
           linear("x_embedder.cond", b * s_cond, w["c_in"], d, "int8"),
           linear("t_embedder.in_layer", 2 * b, 256, d, "int8"),
           linear("t_embedder.out_layer", 2 * b, d, d, "int8"),
           linear("p_embedder.in_layer", b, t["text_emb_dim"], d, "int8"),
           linear("p_embedder.out_layer", b, d, d, "int8")]
    for i in range(t["num_layers"]):
        n = f"double_blocks.{i}"
        ops += [linear(f"{n}.adaLN", 2 * b, d, 12 * d, "int8"),
                linear(f"{n}.to_qkv", lat, d, 3 * d, "int8"),
                linear(f"{n}.to_qkv_t", text, d, 3 * d, "int8"),
                linear(f"{n}.to_out", lat, d, d, "int8"),
                linear(f"{n}.to_out_t", text, d, d, "int8"),
                attention(f"{n}.attention", b, heads, s, hd)]
        ops += _moe(f"{n}.moe", lat, w, top_k)
        ops += _swiglu(f"{n}.ff_t", text, d, w["ffn"], 1)
    for j in range(t["num_single_layers"]):
        n = f"single_blocks.{j}"
        ops += [linear(f"{n}.adaLN", 2 * b, d, 6 * d, "int8"),
                linear(f"{n}.to_qkv", full, d, 3 * d, "int8"),
                linear(f"{n}.to_out", full, d, d, "int8"),
                attention(f"{n}.attention", b, heads, s, hd)]
        ops += _moe(f"{n}.moe", full, w, top_k)
    ops += [linear("final_layer.adaLN", b, d, 2 * d, "int8"),
            linear("final_layer.linear", b * s_img, d, w["c_in"], "int8")]
    return ops


def caption_ops(t: Dict[str, Any], b: int, s_t5: int,
                s_llama: int) -> List[Op]:
    """The caption projections of one request: the T5 slot and each
    Llama stream."""
    w = dims(t)
    k = t["caption_channels"][0]
    return ([linear("caption_projection.t5", b * s_t5, k, w["d"], "int8")]
            + [linear(f"caption_projection.{i}", b * s_llama, k, w["d"],
                      "int8") for i in range(w["streams"])])
