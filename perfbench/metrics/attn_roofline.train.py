"""% of the flash attention's roofline in the QLoRA step: the bound seconds
of the profiled steps' attention forward and backward over the device
seconds of ``csrc/flash_attention.cu``'s forward, RoPE pre-pass and the dK/dV
and dQ passes.  The remat forward's second pass is in the device seconds
and not in the bound."""

from perfbench.core import readers

FAMILIES = readers.ATTENTION
KINDS = ("attention",)


def read(ctx):
    return readers.roofline(ctx, KINDS, FAMILIES)
