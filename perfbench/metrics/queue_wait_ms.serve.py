"""Median ms, over the profiled requests' ``edit.denoise.step`` spans, from
the step's start on the host to its start on the device (both on the host
clock the program maps its CUDA events onto): how long the step's first
work waited behind work already queued.  Near 0 the card waits for the
host.  None where the program records no such span."""

import statistics


def read(ctx):
    try:
        from loongx_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    waits = [s.device_start_ns - s.host_start_ns for s in profiling.spans()
             if s.name == "edit.denoise.step"]
    if not waits:
        return None
    return statistics.median(waits) / 1e6
