"""Device ms per denoise step: the mean over the profiled requests'
``edit.denoise.step`` spans (``sampling/generate.py``'s ``denoise``, one a
step: the DiT forward and the Euler update), each timed by the program's
pair of CUDA events.  None where the program records no such span."""


def read(ctx):
    try:
        from loongx_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    steps = [s for s in profiling.spans() if s.name == "edit.denoise.step"]
    if not steps:
        return None
    return sum(s.device_end_ns - s.device_start_ns for s in steps) \
        / len(steps) / 1e6
