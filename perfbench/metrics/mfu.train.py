"""% of the card's peak that the QLoRA step's work would take: the at-peak
seconds of a step's forward, input gradients, LoRA products and attention
forward and backward (bf16 at 989 TFLOP/s; `perfbench.core.flops`, no remat
recompute) of every step of the traced run's window over those steps' own
wall-clock seconds (the profiled steps inside; the harness's reading of
the trace between steps left out)."""

from perfbench.core import readers


def read(ctx):
    return readers.mfu(ctx)
