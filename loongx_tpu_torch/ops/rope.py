"""FLUX multi-axis rotary position embeddings (counterpart of
``loongx_tpu/ops/rope.py``): each token carries a 3-component position id,
each component rotates a contiguous slice of the head dimension (16, 56, 56
of 128 for FLUX) with interleaved (even, odd) pairs and theta = 10000.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rope_embed(ids: torch.Tensor, axes_dim: Sequence[int] = (16, 56, 56),
               theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids [S, A] -> (cos, sin), each [S, head_dim] float32, repeated in
    interleaved pairs (cos[..., 2k] == cos[..., 2k+1])."""
    ids = ids.float()
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(axes_dim):
        exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                                device=ids.device) / dim
        freqs = 1.0 / (theta ** exponent)
        angles = ids[:, axis, None] * freqs[None, :]
        cos_parts.append(torch.repeat_interleave(torch.cos(angles), 2, dim=-1))
        sin_parts.append(torch.repeat_interleave(torch.sin(angles), 2, dim=-1))
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate [..., S, D] head vectors: out[2i] = x[2i] cos - x[2i+1] sin,
    out[2i+1] = x[2i+1] cos + x[2i] sin, in float32, cast back."""
    xf = x.float()
    pair = xf.unflatten(-1, (-1, 2))
    x_rot = torch.stack([-pair[..., 1], pair[..., 0]], dim=-1).flatten(-2)
    return (xf * cos + x_rot * sin).to(x.dtype)
