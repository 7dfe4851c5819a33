"""% of the int8 GEMMs' roofline in the served edit: the bound seconds of
every DiT linear of the profiled requests (max of operations at 1979 TOP/s
and bytes at 3.35 TB/s, each input read once, each output written once)
over the device seconds of the kernel families below: the GEMMs of
``csrc/quant_matmul.cu`` and the activation and row-stats passes that feed
them."""

from perfbench.core import readers

FAMILIES = readers.GEMM
KINDS = ("linear",)


def read(ctx):
    return readers.roofline(ctx, KINDS, FAMILIES)
