"""% of the flash attention's roofline in the served edit: the bound
seconds of the profiled requests' 57 attentions a forward (4 B H S^2 D
operations at 989 TFLOP/s) over the device seconds of
``csrc/flash_attention.cu``'s forward and its RoPE pre-pass."""

from perfbench.core import readers

FAMILIES = readers.ATTENTION
KINDS = ("attention",)


def read(ctx):
    return readers.roofline(ctx, KINDS, FAMILIES)
