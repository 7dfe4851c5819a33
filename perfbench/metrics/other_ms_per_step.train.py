"""Device ms per QLoRA step of every operation outside the GEMM and
attention families: PyTorch's elementwise work, casts, layer norms, the
LoRA products and the optimizer."""

from perfbench.core import readers

FAMILIES = readers.GEMM + readers.ATTENTION


def read(ctx):
    return readers.other_ms_per_step(ctx, FAMILIES)
