"""% of the card's peak that the served edit's DiT work would take: the
at-peak seconds of each request's 28 forwards (int8 products at 1979
TOP/s, bf16 attention at 989 TFLOP/s; `perfbench.core.flops`) of every
request of the traced run's window over those requests' own wall-clock
seconds (the profiled requests and the stage spans' synchronizes inside;
the harness's reading of the trace between requests left out)."""

from perfbench.core import readers


def read(ctx):
    return readers.mfu(ctx)
