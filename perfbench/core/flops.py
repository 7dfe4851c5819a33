"""Operations and bytes of the measured work, from the configuration's
shapes, and the card's data-sheet peaks: the yardstick of the `mfu` and
`*_roofline` metrics.

A linear [M, K] x [K, N] costs 2 M K N operations and moves its input once
(bf16 activations, int8 weights, float32 per-channel scales, bf16 bias)
and its output once (bf16); an attention over [B, H, S, D] costs 4 B H S^2
D in its forward (Q K^T and P V) and twice that in its backward (dV, dP,
dQ, dK), and moves q, k, v and the output once.  Its bound is the larger of
operations over the peak of its precision and bytes over the memory
bandwidth.  Nothing recomputed (the training step's remat) is counted.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12


class Op(NamedTuple):
    name: str
    kind: str         # "linear" | "linear_dx" | "lora" | "attention"
    ops: float
    bytes: float
    precision: str    # a key of PEAK_OPS

    @property
    def peak_s(self) -> float:
        """At-peak seconds of the operations alone."""
        return self.ops / PEAK_OPS[self.precision]

    @property
    def bound_s(self) -> float:
        return max(self.peak_s, self.bytes / HBM_BYTES_PER_S)


def linear(name: str, m: int, k: int, n: int, precision: str) -> Op:
    return Op(name, "linear", 2.0 * m * k * n,
              m * k * 2 + k * n + n * 4 + n * 2 + m * n * 2, precision)


def linear_dx(name: str, m: int, k: int, n: int) -> Op:
    """dx [M, K] = (dy [M, N] * scale) W^T in bf16."""
    return Op(name, "linear_dx", 2.0 * m * k * n,
              m * n * 2 + k * n + n * 4 + m * k * 2, "bf16")


def attention(name: str, b: int, h: int, s: int, d: int,
              backward: bool = False) -> Op:
    qkvo = 4 * b * s * h * d * 2
    if backward:  # reads q, k, v, o, dO; writes dq, dk, dv
        return Op(name, "attention", 8.0 * b * h * s * s * d, 2 * qkvo, "bf16")
    return Op(name, "attention", 4.0 * b * h * s * s * d, qkvo, "bf16")


def flux_linears(t: Dict[str, Any], b: int, s_txt: int, s_img: int,
                 s_cond: int) -> List[Tuple[str, int, int, int, bool]]:
    """(path, M, K, N, input needs a gradient in the QLoRA step) of every
    int8 linear of one forward: q, k and v as one product, the single
    blocks' proj_out whole, the timestep / guidance / pooled MLPs at the
    image's and the condition's timestep."""
    h = t["num_attention_heads"] * t["attention_head_dim"]
    mlp, c_in = 4 * h, t["in_channels"]
    lat, full = b * (s_img + s_cond), b * (s_txt + s_img + s_cond)
    out = [("x_embedder.img", b * s_img, c_in, h, False),
           ("x_embedder.cond", b * s_cond, c_in, h, False),
           ("context_embedder", b * s_txt, t["joint_attention_dim"], h, False)]
    mlps = [("time_in", 256), ("vector_in", t["pooled_projection_dim"])]
    if t["guidance_embeds"]:
        mlps.append(("guidance_in", 256))
    for name, k_in in mlps:
        out += [(f"{name}.in_layer", 2 * b, k_in, h, False),
                (f"{name}.out_layer", 2 * b, h, h, False)]
    for i in range(t["num_layers"]):
        d = f"double_blocks.{i}"
        out += [(f"{d}.norm1", 2 * b, h, 6 * h, False),
                (f"{d}.norm1_context", b, h, 6 * h, False),
                (f"{d}.to_qkv", lat, h, 3 * h, True),
                (f"{d}.add_qkv", b * s_txt, h, 3 * h, i > 0),
                (f"{d}.to_out", lat, h, h, True),
                (f"{d}.to_add_out", b * s_txt, h, h, True),
                (f"{d}.ff.in", lat, h, mlp, True),
                (f"{d}.ff.out", lat, mlp, h, True),
                (f"{d}.ff_context.in", b * s_txt, h, mlp, True),
                (f"{d}.ff_context.out", b * s_txt, mlp, h, True)]
    for i in range(t["num_single_layers"]):
        s = f"single_blocks.{i}"
        out += [(f"{s}.norm", 2 * b, h, 3 * h, False),
                (f"{s}.to_qkv", full, h, 3 * h, True),
                (f"{s}.proj_mlp", full, h, mlp, True),
                (f"{s}.proj_out", full, h + mlp, h, True)]
    out += [("norm_out", b, h, 2 * h, False),
            ("proj_out", b * s_img, h, c_in, True)]
    return out


def _lora_target(path: str) -> bool:
    if path.startswith("double_blocks"):
        return path.endswith((".norm1", ".to_qkv", ".to_out", ".ff.out"))
    if path.startswith("single_blocks"):
        return path.endswith((".norm", ".to_qkv", ".proj_mlp", ".proj_out"))
    return path == "x_embedder.cond"


def serve_forward(t: Dict[str, Any], b: int, s_txt: int, s_img: int,
                  s_cond: int) -> List[Op]:
    """One W8A8 forward: int8 products, bf16 attention."""
    h, d = t["num_attention_heads"], t["attention_head_dim"]
    s = s_txt + s_img + s_cond
    ops = [linear(p, m, k, n, "int8")
           for p, m, k, n, _ in flux_linears(t, b, s_txt, s_img, s_cond)]
    for i in range(t["num_layers"] + t["num_single_layers"]):
        ops.append(attention(f"attention.{i}", b, h, s, d))
    return ops


def train_step(t: Dict[str, Any], b: int, s_txt: int, s_img: int,
               s_cond: int, rank: int) -> List[Op]:
    """One QLoRA step: the weight-only forward (bf16 products of the
    widened int8 weights), the input gradients of the linears whose input
    needs one, the LoRA products (forward; dA, dB and the delta's
    gradient; dx through A where the input needs a gradient), and the
    attention forward and backward."""
    h, d = t["num_attention_heads"], t["attention_head_dim"]
    s = s_txt + s_img + s_cond
    ops: List[Op] = []
    for p, m, k, n, needs_dx in flux_linears(t, b, s_txt, s_img, s_cond):
        ops.append(linear(p, m, k, n, "bf16"))
        if needs_dx:
            ops.append(linear_dx(p, m, k, n))
        if _lora_target(p):
            # q, k and v carry an adapter each: three of width h in to_qkv
            parts = 3 if p.endswith("to_qkv") else 1
            w = n // parts
            fwd = 2.0 * m * rank * (k + w)               # x A, (x A) B
            bwd = 2.0 * m * rank * (2 * w + k)           # dB, d(x A), dA
            if needs_dx:
                bwd += 2.0 * m * rank * k                # d(x A) A^T
            ops.append(Op(f"{p}.lora", "lora", parts * (fwd + bwd), 0.0,
                          "bf16"))
    for i in range(t["num_layers"] + t["num_single_layers"]):
        ops.append(attention(f"attention.{i}", b, h, s, d))
        ops.append(attention(f"attention_bwd.{i}", b, h, s, d, backward=True))
    return ops


def peak_seconds(ops: List[Op]) -> float:
    return sum(o.peak_s for o in ops)


def bound_seconds(ops: List[Op], kinds) -> float:
    return sum(o.bound_s for o in ops if o.kind in kinds)
