"""% of the int8 GEMMs' roofline in the QLoRA step: the bound seconds of
every DiT linear's weight-only forward and input gradient of the profiled
steps (bf16 at 989 TFLOP/s, bytes at 3.35 TB/s) over the device seconds of
the kernel families below: ``csrc/quant_matmul.cu`` and
``csrc/quant_matmul_t.cu`` (the transposed GEMMs and their pre-scale pass).
The remat forward's second pass is in the device seconds and not in the
bound."""

from perfbench.core import readers

FAMILIES = readers.GEMM
KINDS = ("linear", "linear_dx")


def read(ctx):
    return readers.roofline(ctx, KINDS, FAMILIES)
