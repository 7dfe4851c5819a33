"""Device operations the profiler saw per QLoRA step of the profiled steps
(kernels, copies and fills of every source): the host's launch load."""

from perfbench.core import readers


def read(ctx):
    return readers.device_events_per_step(ctx)
