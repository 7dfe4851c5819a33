"""% of the expert path's roofline in the served HiDream edit: the bound
seconds of every SwiGLU product of the profiled requests (the routed
experts at top-k rows a token, the shared expert, the text stream's dense
SwiGLU; `perfbench.core.flops_hidream`'s ``"expert"`` operations: max of
operations at 1979 TOP/s and bytes at 3.35 TB/s) over the device seconds of
``csrc/moe_gemm.cu``'s kernels (``moe_``: the router, the plan, the
quantization passes and gathers, the grouped GEMMs, the combine)."""

from perfbench.core import readers

FAMILIES = ("moe_",)
KINDS = ("expert",)


def read(ctx):
    return readers.roofline(ctx, KINDS, FAMILIES)
