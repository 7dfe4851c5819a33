"""Tensor-parallel flash attention (counterpart of
``loongx_tpu/parallel/tp_attention.py``).

Attention is independent across heads and across batch rows, so each rank
runs the port's flash forward (``ops/flash_attention.py``: the wgmma
kernel, its RoPE pre-pass, both layouts, the int8 QK^T mode) on the heads
and rows it holds and no collective runs.  The JAX package wraps its Pallas
kernel in ``shard_map`` over global arrays; here the arrays are already
the rank's local shards.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from loongx_tpu_torch.ops import flash_attention as fa


def tp_flash_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, *, cond_start: int,
                       mode: str = "union", c_factor: Optional[float] = None,
                       rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                       layout: str = "bhsd",
                       int8_attn: bool = False) -> torch.Tensor:
    """Flash attention on this rank's shard: q / k / v are the heads (and
    batch rows) the rank holds, on the mesh's device; the output is the
    same shard.  ``rope`` tables cover the whole sequence, which no rank
    splits.  Nothing is exchanged between ranks."""
    if q.device != mesh.device:
        raise ValueError(f"the rank's shard is on {q.device}, its mesh on "
                         f"{mesh.device}")
    return fa.flash_attention(q, k, v, cond_start=cond_start, mode=mode,
                              c_factor=c_factor, rope=rope, layout=layout,
                              int8_attn=int8_attn)
