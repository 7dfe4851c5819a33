"""% of the traced window's wall time over the profiled requests in which
no operation ran on the card."""

from perfbench.core import readers


def read(ctx):
    return readers.idle_share(ctx)
