"""Pooling ops for the biosignal encoders (counterpart of
``loongx_tpu/ops/pooling.py``): exact ``nn.AdaptiveAvgPool1d`` bins as an
averaging matrix, feature pyramid pooling and spatial pyramid pooling."""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def _pool_matrix(length: int, out_size: int) -> np.ndarray:
    """[length, out_size] M with x @ M == AdaptiveAvgPool1d(out)(x): bin i
    averages [floor(i*L/out), ceil((i+1)*L/out))."""
    m = np.zeros((length, out_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * length) // out_size
        end = -(-((i + 1) * length) // out_size)
        m[start:end, i] = 1.0 / (end - start)
    return m


def adaptive_avg_pool1d(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """x: [..., L] -> [..., out_size]."""
    length = x.shape[-1]
    if length == out_size:
        return x
    m = torch.from_numpy(_pool_matrix(length, out_size)).to(x.device)
    return torch.matmul(x.float(), m).to(x.dtype)


def feature_pyramid_pooling(x: torch.Tensor,
                            output_sizes: Sequence[int]) -> torch.Tensor:
    """x: [B, C, L] -> [B, C, sum(output_sizes)]."""
    return torch.cat([adaptive_avg_pool1d(x, s) for s in output_sizes], -1)


def spatial_pyramid_pooling(x: torch.Tensor, output_size: int,
                            adaptive: bool = False) -> torch.Tensor:
    """[B, C, L] -> [B, C, output_size] by zero-pad / truncate, or by
    adaptive average pooling."""
    length = x.shape[-1]
    if length == output_size:
        return x
    if adaptive:
        return adaptive_avg_pool1d(x, output_size)
    if length < output_size:
        return F.pad(x, (0, output_size - length))
    return x[..., :output_size]
