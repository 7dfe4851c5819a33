"""Device operations the profiler saw per denoise step of the profiled
requests (kernels, copies and fills of every source, the encodes and the
decode included): the host's launch load."""

from perfbench.core import readers


def read(ctx):
    return readers.device_events_per_step(ctx)
