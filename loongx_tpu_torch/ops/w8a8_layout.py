"""The memory layout of the int8 weights: ``[K, N]`` or K-major.

An int8 linear's weight is stored ``[K, N]`` (a stack ``[NB, K, N]``, the
fused qkv of the tensor-parallel layout ``[NB, K, 3, H]``, an expert stack
``[NB, E, K, N]``): row-major, n contiguous.  8-bit ``wgmma`` takes its B
operand only K-major, so the W8A8 GEMMs on wgmma (``qmm_wgmma_kernel``,
``moe_gemm_kernel``, csrc/w8a8_pipeline.cuh) read the weight K-major: each
``[K, N]`` matrix stored as its transpose ``[N, K]``, k contiguous, which
TMA lands as ``wgmma`` reads it.

The layout is changed in place and marked by the strides, not the shape:
the tensor keeps its logical shape and values (``w[..., k, n]`` is the same
code either way) and only its strides change -- K-major, the contraction
axis has stride 1 and the axes after it follow it (`kmajor_strides`).  So
``[K, N]`` is told from ``[N, K]`` at K = N, and everything that reads the
weight through PyTorch (the plain versions, the dequantised products, a
tensor-parallel shard's slice, a checkpoint's ``contiguous()`` copy, which
stays ``[K, N]``) reads either layout alike; only kernels that read the raw
bytes care.  `to_kmajor` / `to_kn` move the bytes one ``[K, N]`` matrix at
a time (the transient is one matrix) and set the strides with
``Tensor.set_``, so every holder of the tensor object sees the new layout
and the card holds one copy.  Each move counts one in
``cuda_build.LAUNCHES`` under ``"w8a8_layout:kmajor"`` or
``"w8a8_layout:kn"`` (keys with ``:``, which the launch counts of
`utils.profiling` leave out).

The bytes move only where every view stays true: a tensor that owns its
memory, or a view of the whole of one (a leaf built by ``[None]`` or a
reshape), whose base moves with it.  A view of part of a tensor (one block
of a stack) is left as it is: `to_kmajor` returns False for it.  They move
only on the devices whose kernels read them (`DEVICES`: CUDA); a CPU
tensor keeps its layout, since the plain versions read either.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from loongx_tpu_torch.ops import cuda_build

KMAJOR = "w8a8_layout:kmajor"
KN = "w8a8_layout:kn"
DEVICES = ("cuda",)  # the device types whose int8 weights change layout


def _contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    strides, acc = [], 1
    for size in reversed(shape):
        strides.append(acc)
        acc *= size
    return tuple(reversed(strides))


def kmajor_strides(shape: Sequence[int], kdim: int) -> Tuple[int, ...]:
    """The strides of a K-major tensor of logical ``shape`` whose
    contraction axis is ``kdim``: memory ordered as the axes before
    ``kdim``, those after it, then ``kdim`` (stride 1)."""
    k = shape[kdim]
    tail = _contiguous_strides(shape[kdim + 1:])
    n = math.prod(shape[kdim + 1:])
    head = _contiguous_strides(shape[:kdim])
    return (tuple(s * k * n for s in head) + (1,) + tuple(s * k for s in tail))


def _matches(t: torch.Tensor, strides: Sequence[int]) -> bool:
    return all(a == b for a, b, size in zip(t.stride(), strides, t.shape)
               if size > 1)


def layout(t: torch.Tensor, kdim: int) -> Optional[str]:
    """``"kn"`` (row-major, the stored layout), ``"kmajor"`` or None for
    ``t`` with contraction axis ``kdim``."""
    if _matches(t, _contiguous_strides(t.shape)):
        return "kn"
    if _matches(t, kmajor_strides(t.shape, kdim)):
        return "kmajor"
    return None


def is_kmajor(t: torch.Tensor, kdim: int) -> bool:
    return layout(t, kdim) == "kmajor"


def _base_kdim(shape: Sequence[int], k: int, n: int) -> Optional[int]:
    """The axis of a base tensor of ``shape`` that holds a view's
    contraction axis of ``k`` followed by ``n`` elements."""
    for d in range(len(shape) - 1, -1, -1):
        if shape[d] == k and math.prod(shape[d + 1:]) == n:
            return d
    return None


def _move(t: torch.Tensor, kdim: int, kmajor: bool) -> None:
    """Transpose each [K, N] matrix of ``t`` (memory of its own) in place,
    one at a time, and set its strides."""
    k = t.shape[kdim]
    n = math.prod(t.shape[kdim + 1:])
    raw = t.as_strided((t.numel() // (k * n), k * n), (k * n, 1))
    for i in range(raw.shape[0]):
        mat = raw[i]
        src = mat.view(k, n) if kmajor else mat.view(n, k)
        mat.copy_(src.t().contiguous().view(-1))
    strides = (kmajor_strides(t.shape, kdim) if kmajor
               else _contiguous_strides(t.shape))
    t.set_(t.untyped_storage(), t.storage_offset(), t.shape, strides)
    cuda_build.LAUNCHES[KMAJOR if kmajor else KN] += 1


def _relayout(t: torch.Tensor, kdim: int, kmajor: bool) -> bool:
    # the common cases first: a leaf already in the layout its route reads
    if kmajor:
        if t.stride(kdim) == 1 and _matches(t, kmajor_strides(t.shape, kdim)):
            return True
    elif t.is_contiguous():
        return True
    target = "kmajor" if kmajor else "kn"
    now = layout(t, kdim)
    if now == target:
        return True
    if now is None or t.device.type not in DEVICES:
        return False
    with torch.inference_mode():
        base = t._base
        if base is None:
            _move(t, kdim, kmajor)
            return True
        # a view of the whole of its base: the base moves, the view follows
        k, n = t.shape[kdim], math.prod(t.shape[kdim + 1:])
        bk = _base_kdim(base.shape, k, n)
        if (base.data_ptr() != t.data_ptr() or base.numel() != t.numel()
                or bk is None or layout(base, bk) is None):
            return False
        if layout(base, bk) != target:
            _move(base, bk, kmajor)
        strides = (kmajor_strides(t.shape, kdim) if kmajor
                   else _contiguous_strides(t.shape))
        t.set_(t.untyped_storage(), t.storage_offset(), t.shape, strides)
        return True


def to_kmajor(t: torch.Tensor, kdim: int) -> bool:
    """Make int8 weight ``t`` (contraction axis ``kdim``) K-major in place
    (module docstring); True where it is K-major afterwards."""
    return _relayout(t, kdim, True)


def to_kn(t: torch.Tensor, kdim: int) -> bool:
    """Make ``t`` row-major ([K, N], as stored) in place; True where it is
    row-major afterwards."""
    return _relayout(t, kdim, False)
